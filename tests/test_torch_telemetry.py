"""The port's telemetry planes (autodist_tpu_torch.telemetry,
utils/tracing.py) against the JAX package's, on the CPU.

- Registry and wire: the same metric operations in both packages give
  snapshots that wire-encode byte for byte alike and the same OpenMetrics
  text; the port's Chrome trace and its JSONL span, event and reqtrace
  dumps load in JAX's ``telemetry.cluster`` loaders and
  ``tools/tracedump.py`` ``merge_dumps``.
- Names: a tiny ``train()`` (d64 x 2) with spans, profiling and health on,
  in each package, books the same span, counter and gauge names, but for
  :data:`JAX_ONLY` and :data:`PORT_ONLY`. Both run in one child process,
  so neither package's process-wide registry carries other tests' names.
- Profiles: the profile the port's run wrote loads in JAX's
  ``tools/adprof.py`` (``load_profile``, ``summarize``, ``diff``) and
  calibrates the port's autotuner (``_load_calibration``, source
  ``profile:...``); ``peak_spec`` gives the H100 rows by name, and the
  flags override.
- Memory: census, claims and budget sources as in JAX; ``dump_stage``
  leaves the state unchanged.
- The PS plane: JAX's ``tools/adtop.py`` ``render`` draws a port server's
  ``status`` (the opcodes' frames are in ``test_torch_ps_transport.py``).
"""

import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist, const, telemetry
from autodist_tpu_torch.telemetry import memplane, openmetrics, profiling, reqtrace
from autodist_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parents[1]
ONE = {"nodes": [{"address": "localhost", "gpus": [0]}]}
TINY = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32)
# Names one package books and the other cannot, on the CPU: PyTorch has no
# live-array list, so without a card the port writes no device.live_*
# gauge; the port's runner counts nothing JAX's does not.
JAX_ONLY = {"device.live_buffers", "device.live_bytes"}
PORT_ONLY = set()


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_cli", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_planes():
    telemetry.disable()
    telemetry.clear()
    # The registry's event ring is separate from the spans: a port test run
    # earlier in the same process (health, the recorder, recovery) leaves
    # its health.anomaly events there.
    telemetry.registry().clear_events()
    profiling.disable()
    profiling.reset()
    memplane.reset()
    reqtrace.disable()
    reqtrace.clear()


@pytest.fixture(autouse=True)
def _planes_off():
    """Start each test with the port's process-wide planes off and empty,
    and leave them so."""
    _reset_planes()
    yield
    _reset_planes()


# ------------------------------------------------------------ the registry

def _operations(metrics):
    reg = metrics.Registry()
    reg.counter("ps.wire.bytes_sent").inc(4096)
    reg.counter("ps.wire.bytes_sent").inc(17)
    reg.counter("jit.compile_s").inc(0.125)
    reg.gauge("train.steps_per_s").set(3.5)
    reg.gauge("mem.owned.params").set(1 << 20)
    lat = reg.histogram("serve.latency_s.ttft")
    for v in (0.0004, 0.003, 0.2, 7.0):
        lat.observe(v)
    lag = reg.histogram("ps.staleness", metrics.COUNT_BUCKETS)
    for v in (0, 1, 1, 5, 40):
        lag.observe(v)
    reg.histogram("train.health.grad_norm.dist").observe(2.0)
    return reg


def test_registry_wire_and_openmetrics_match_jax():
    """The same operations: equal snapshots, byte-identical wire frames (the
    ``stats`` reply carries them), identical exposition text, and equal
    quantiles and merged histograms."""
    from autodist_tpu.parallel import wire as jax_wire
    from autodist_tpu.telemetry import metrics as jax_metrics
    from autodist_tpu.telemetry import openmetrics as jax_openmetrics
    from autodist_tpu_torch.parallel import wire
    from autodist_tpu_torch.telemetry import metrics
    jreg, reg = _operations(jax_metrics), _operations(metrics)
    assert reg.snapshot() == jreg.snapshot()
    assert wire.encode(("ok", reg.snapshot())) == jax_wire.encode(("ok", jreg.snapshot()))
    assert openmetrics.render(reg) == jax_openmetrics.render(jreg)
    h, jh = reg.snapshot()["ps.staleness"], jreg.snapshot()["ps.staleness"]
    assert metrics.quantile(h, 0.5) == jax_metrics.quantile(jh, 0.5)
    assert metrics.merge_histograms([h, h]) == jax_metrics.merge_histograms([jh, jh])


def test_trace_and_dumps_load_in_jax(tmp_path):
    """Spans, events and request marks recorded by the port: its Chrome
    trace has JAX's schema, and its JSONL dumps load in JAX's loaders and
    merge through ``tools/tracedump.py`` into one Chrome trace."""
    from autodist_tpu.telemetry import cluster as jax_cluster
    telemetry.enable()
    reqtrace.enable()
    with telemetry.span("train.dispatch", step=1):
        with telemetry.span("runner.run.dispatch"):
            time.sleep(0.001)
    telemetry.event("health.anomaly", kind="nonfinite", step=1)
    reqtrace.mark(7, "sent", size=3)
    reqtrace.mark(7, "done")
    chrome = telemetry.export_chrome_trace(str(tmp_path / "host.json"))
    events = json.load(open(chrome))["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} == {"train.dispatch",
                                                            "runner.run.dispatch"}
    spans = telemetry.dump_spans_jsonl(str(tmp_path / "spans.jsonl"), worker_id=1)
    evs = telemetry.dump_events_jsonl(str(tmp_path / "events.jsonl"))
    marks = telemetry.dump_reqtrace_jsonl(str(tmp_path / "req.jsonl"), worker_id=1)
    state = jax_cluster.load_trace_jsonl(spans)
    assert sorted(state["names"]) == ["runner.run.dispatch", "train.dispatch"]
    assert [e["name"] for e in jax_cluster.load_events_jsonl(evs)
            if e["name"] == "health.anomaly"] == ["health.anomaly"]
    req = jax_cluster.load_reqtrace_jsonl(marks)
    assert [m["phase"] for m in jax_cluster.reqtrace_marks(req)] == ["sent", "done"]
    out = _tool("tracedump").merge_dumps(str(tmp_path / "merged.json"), [spans],
                                         event_files=[evs])
    merged = json.load(open(out))["traceEvents"]
    assert {"train.dispatch", "health.anomaly"} <= {e["name"] for e in merged}


# ------------------------------------------------------------ the names child

def _tiny_train(autodist_mod, builder, tlm, train_fn, params, optimizer, dtype, batches):
    ad = autodist_mod(**({"resource_info": ONE, "device": "cpu"}
                         if builder is AllReduce else {}), strategy_builder=builder())
    cfg = tlm.TransformerLMConfig(**TINY, dtype=dtype, tied_output=False, fused_head=False)
    runner = ad.create_distributed_session(tlm.make_loss_fn(tlm.TransformerLM(cfg)), params,
                                           optimizer)
    train_fn(runner, params, batches, steps=4, log_every=2)


def _names_main(workdir: pathlib.Path):
    """The child: JAX's tiny train(), then the port's, spans, profiling and
    health armed from the environment; writes the names each booked."""
    import jax
    import optax
    import autodist_tpu
    from autodist_tpu import telemetry as jax_telemetry
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu.training import train as jtrain
    from autodist_tpu_torch import from_jax_params
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.training import train

    def batches(i):
        rng = np.random.RandomState(10 + i)
        return {"tokens": rng.randint(0, TINY["vocab_size"], size=(8, 17)).astype(np.int32)}

    def booked(tel):
        return {"spans": sorted({s[0] for s in tel.snapshot_spans()}),
                "metrics": sorted(tel.snapshot()),
                "events": sorted({e["name"] for e in tel.events()})}

    # The names do not depend on the values: seeded numpy leaves of the
    # init's shapes, which spares compiling the init.
    cfg = jlm.TransformerLMConfig(**TINY, dtype=np.float32, tied_output=False,
                                  fused_head=False)
    shapes = jax.eval_shape(lambda k: jlm.init_params(cfg, k)[1], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, s: np.ones(s.shape, s.dtype) if "scale" in jax.tree_util.keystr(path)
        else (0.02 * rng.standard_normal(s.shape)).astype(s.dtype), shapes)
    os.environ["AUTODIST_PROFILE_DIR"] = str(workdir / "jax_profiles")
    _tiny_train(autodist_tpu.AutoDist, JAllReduce, jlm, jtrain, jparams, optax.adam(1e-3),
                np.float32, batches)
    os.environ["AUTODIST_PROFILE_DIR"] = str(workdir / "port_profiles")
    _tiny_train(AutoDist, AllReduce, tlm, train, from_jax_params(jparams),
                lambda p: torch.optim.Adam(p, lr=1e-3), torch.float32, batches)
    (workdir / "names.json").write_text(json.dumps({"jax": booked(jax_telemetry),
                                                    "port": booked(telemetry)}))


@pytest.fixture(scope="module", autouse=True)
def names_run(tmp_path_factory):
    """The child, started before the module's first test so that it runs
    beside them (the tests that read it come last); calling it waits and
    returns its workdir."""
    workdir = tmp_path_factory.mktemp("names")
    env = dict(os.environ, AUTODIST_TELEMETRY="1", AUTODIST_PROFILE="1", AUTODIST_HEALTH="1",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, "names", str(workdir)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    @functools.cache
    def wait():
        try:
            log = proc.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("the names child did not finish in 120 s")
        assert proc.returncode == 0, log[-3000:]
        return workdir

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()


def test_peak_spec_h100_rows_and_overrides(monkeypatch):
    spec = profiling.peak_spec()
    assert (spec.flops_per_s, spec.membw_bytes_per_s, spec.source) == (None, None, "unknown")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    spec = profiling.peak_spec()
    assert (spec.flops_per_s, spec.membw_bytes_per_s) == (989e12, 3.35e12)
    assert spec.source == "device:NVIDIA H100 80GB HBM3"
    assert not any(k.startswith("TPU") for k in profiling.PEAK_BF16_FLOPS)
    monkeypatch.setenv("AUTODIST_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("AUTODIST_PEAK_MEMBW", "2e12")
    assert profiling.peak_spec().to_dict() == {"flops_per_s": 1e15,
                                              "membw_bytes_per_s": 2e12, "source": "env"}


def _plant_profile(prof_dir, name, flops_per_step, compute_share, peaks, mtime):
    path = prof_dir / name
    path.write_text(json.dumps({
        "schema": profiling.PROFILE_SCHEMA, "peaks": peaks,
        "summary": {"wall_s": 1.0, "steps": 10, "flops_per_step": flops_per_step,
                    "shares": {"compute": compute_share}, "host_s_per_dispatch": 0.002}}))
    os.utime(path, (mtime, mtime))


@pytest.mark.parametrize("peak_from", ["env", "profile"])
def test_calibration_skips_a_profile_above_the_peak(peak_from, tmp_path, monkeypatch):
    """A profile whose fit exceeds the card's peak FLOP/s (here 1e18, as a
    compute share booked as host time gives) is skipped with a warning for
    the newest one the peak admits, else the bundled calibration. The peak
    is ``peak_spec``'s, else the profile's own ``peaks``."""
    autotune = importlib.import_module("autodist_tpu_torch.strategy.autotune")
    warned = []
    monkeypatch.setattr(autotune._log, "warning", lambda msg, *args: warned.append(msg % args))
    peaks = {"flops_per_s": None, "membw_bytes_per_s": None, "source": "unknown"}
    if peak_from == "env":
        monkeypatch.setenv("AUTODIST_PEAK_FLOPS", "989e12")
    else:
        peaks = {"flops_per_s": 989e12, "membw_bytes_per_s": 3.35e12,
                 "source": "device:NVIDIA H100 80GB HBM3"}
    monkeypatch.setenv("AUTODIST_PROFILE_DIR", str(tmp_path))
    _plant_profile(tmp_path, "profile-a.json", 1e13, 0.5, peaks, 1000)     # 2e14 FLOP/s
    _plant_profile(tmp_path, "profile-b.json", 1e15, 0.01, peaks, 2000)    # 1e18 FLOP/s
    calib, source = autotune._load_calibration(None)
    assert source == "profile:profile-a.json" and calib.flops_per_s == pytest.approx(2e14)
    [msg] = warned
    assert "profile-b.json" in msg and "FLOP/s 1e+18 exceeds the peak 9.89e+14" in msg
    os.remove(tmp_path / "profile-a.json")
    assert autotune._load_calibration(None)[1] == "bundled-default"


def test_device_time_is_compute_and_the_host_spans_share_the_rest():
    """On a card a period's ``compute`` is its dispatches' device time; the
    host phases' spans are scaled into the rest of the period when they
    overlap the card's time, and leave the remainder to ``host`` when they
    do not fill it. On the host ``device_timed`` leaves a span as it is."""
    overlap = {"data_wait": 0.0, "host": 0.8, "comm": 0.0, "readback": 0.1}
    parts = profiling._device_parts(overlap, 1.0, 0.6)
    assert parts["compute"] == 0.6 and sum(parts.values()) == pytest.approx(1.0)
    assert parts["host"] == pytest.approx(0.8 * 0.4 / 0.9)
    assert parts["readback"] == pytest.approx(0.1 * 0.4 / 0.9)
    short = {"data_wait": 0.05, "host": 0.1, "comm": 0.0, "readback": 0.0}
    assert profiling._device_parts(short, 1.0, 0.7) == pytest.approx(
        {"data_wait": 0.05, "host": 0.25, "comm": 0.0, "readback": 0.0, "compute": 0.7})
    assert profiling._device_parts(overlap, 1.0, 1.3) == pytest.approx(
        {"data_wait": 0.0, "host": 0.0, "comm": 0.0, "readback": 0.0, "compute": 1.0})
    profiling.enable()
    span = telemetry.span("runner.run.dispatch")
    assert profiling.device_timed(span, torch.device("cpu")) is span
    assert profiling._drain_device_seconds() is None


def test_env_flags_parse_alike_through_either_reader(monkeypatch):
    """``const.ENV.<NAME>.val`` reads through the ``env_*`` helper of its
    default's type: unset gives the JAX package's default, blank an int's
    default, and a set value the same as the helper."""
    for name, default in const._ENV_DEFAULTS.items():
        monkeypatch.delenv(name, raising=False)
        assert getattr(const.ENV, name).val == default
    monkeypatch.setenv("AUTODIST_PROCESS_ID", " ")
    assert const.ENV.AUTODIST_PROCESS_ID.val == const.env_int("AUTODIST_PROCESS_ID", 0) == 0
    monkeypatch.setenv("AUTODIST_PROCESS_ID", "3")
    assert const.ENV.AUTODIST_PROCESS_ID.val == 3
    monkeypatch.setenv("AUTODIST_HEALTH", "off")
    assert const.ENV.AUTODIST_HEALTH.val is False
    monkeypatch.setenv("AUTODIST_HEALTH_ZMAX", "4.5")
    assert const.ENV.AUTODIST_HEALTH_ZMAX.val == 4.5
    monkeypatch.setenv("AUTODIST_PROFILE_DIR", " /tmp/p ")
    assert const.ENV.AUTODIST_PROFILE_DIR.val == const.env_str("AUTODIST_PROFILE_DIR") == "/tmp/p"


# ------------------------------------------------------------ memory, graphs

def test_memplane_census_and_budget_sources_match_jax(monkeypatch):
    """Claims on the same shapes count the same bytes in both packages (a
    view of a claimed tensor counts once); a freed tree's claim evaporates;
    the budget's source is the env override, else the default, as in JAX
    on a host; an OOM is recognised and booked."""
    import jax.numpy as jnp
    from autodist_tpu.telemetry import memplane as jax_memplane
    shapes = {"a": (64, 32), "b": (128,)}
    jax_memplane.reset()
    try:
        jtree = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
        jax_memplane.tag("params", jtree)
        want = jax_memplane.census()
    finally:
        jax_memplane.reset()
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    params["view"] = params["a"][:8]
    memplane.tag("params", params)
    optimizer = torch.optim.Adam([params["a"].requires_grad_()], lr=1e-3)
    params["a"].grad = torch.ones_like(params["a"])
    optimizer.step()
    memplane.tag("opt_state", optimizer)
    got = memplane.census()
    assert got["params"] == want["params"] == 4 * (64 * 32 + 128)
    assert got["opt_state"] == 2 * 4 * 64 * 32 + 4   # two moments and the step
    owned = memplane.attribute(10 << 20)
    assert owned["other"] == (10 << 20) - got["params"] - got["opt_state"]
    del params, optimizer
    assert "params" not in memplane.census()
    monkeypatch.setenv("AUTODIST_MEM_BUDGET", str(3 << 30))
    assert memplane.device_budget() == jax_memplane.device_budget() == (3 << 30, "env")
    monkeypatch.delenv("AUTODIST_MEM_BUDGET")
    assert memplane.device_budget() == (8 << 30, "default")
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")
    before = telemetry.counter("mem.oom").value
    assert memplane.is_oom_error(oom) and not memplane.is_oom_error(ValueError("shape"))
    memplane.record_oom("runner.run", oom)
    assert telemetry.counter("mem.oom").value == before + 1


def test_dump_stage_leaves_the_state_unchanged(tmp_path, monkeypatch):
    """``AUTODIST_DUMP_GRAPHS``' dumps trace the loss and the step (gradient
    and Adam update) on fake tensors: the run's params, optimizer state and
    step count equal a run without them."""
    monkeypatch.setattr(const, "DEFAULT_GRAPH_DUMP_DIR", str(tmp_path))

    def run(dump):
        monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1" if dump else "0")
        ad = AutoDist(resource_info=ONE, strategy_builder=AllReduce(), device="cpu")
        params = {"w": torch.ones(4, 2), "b": torch.zeros(2)}
        runner = ad.create_distributed_session(
            lambda p, b: ((b["x"] @ p["w"] + p["b"]) ** 2).mean(), params,
            lambda p: torch.optim.Adam(p, lr=0.1))
        state = runner.init(params)
        for i in range(2):
            runner.run(state, {"x": torch.full((8, 4), float(i + 1))})
        return state

    plain, dumped = run(False), run(True)
    assert sorted(os.listdir(tmp_path / "train_step")) == ["0-original.fx.txt",
                                                           "1-distributed.fx.txt"]
    assert "aten.mm" in (tmp_path / "train_step" / "1-distributed.fx.txt").read_text()
    for k in plain.params:
        assert torch.equal(plain.params[k], dumped.params[k])
    for a, b in zip(plain.optimizer.state.values(), dumped.optimizer.state.values()):
        assert all(torch.equal(a[f], b[f]) for f in a)


def test_trace_writes_the_profiler_trace_and_the_host_spans(tmp_path):
    """``tracing.trace`` around a step writes the ``torch.profiler`` Chrome
    trace (host ops on the CPU; the card's kernels too on one) and, beside
    it, the host spans of the window."""
    ad = AutoDist(resource_info=ONE, strategy_builder=AllReduce(), device="cpu")
    params = {"w": torch.ones(4, 2)}
    runner = ad.create_distributed_session(lambda p, b: (b["x"] @ p["w"]).sum(), params,
                                           lambda p: torch.optim.SGD(p, lr=0.1))
    state = runner.init(params)
    with tracing.trace(trace_dir=str(tmp_path), with_host_spans=True):
        runner.run(state, {"x": torch.ones(8, 4)})
    device = json.load(open(tmp_path / "device_trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in device)
    host = json.load(open(tmp_path / "host_spans_w0.json"))["traceEvents"]
    # The first dispatch of a signature is its build, a jit.compile span.
    assert {"runner.shard_batch", "jit.compile"} <= {e["name"] for e in host}
    assert not telemetry.enabled()


def test_cost_benchmark_runs_every_plane_and_disarms_them():
    """``examples/benchmark/telemetry.py`` on the host: a rate for each plane
    in both regimes, and every plane off again afterwards."""
    from autodist_tpu_torch.examples.benchmark import telemetry as bench
    out = bench.main(["--device", "cpu", "--d_model", "32", "--n_layers", "1", "--vocab",
                      "64", "--micro_batch", "2", "--seq_len", "8", "--steps", "3",
                      "--log_every", "1"])
    assert set(out["tokens_per_s"]) == {"no profiler yet", "after a profiler window"}
    assert all(set(by) == set(bench.PLANES) and all(v > 0 for v in by.values())
               for by in out["tokens_per_s"].values())
    assert not telemetry.enabled() and not profiling.active()
    assert "AUTODIST_HEALTH" not in os.environ and openmetrics.get_exporter() is None


# ------------------------------------------------------------ the PS plane

def test_adtop_renders_a_port_server_status():
    from autodist_tpu_torch.parallel import ps_transport, staleness
    from autodist_tpu_torch.runner import TrainState
    class Stub:
        service = staleness.ParameterService(
            TrainState(step=0, params={"w": torch.zeros(3)}, optimizer=None), lambda s, g: s)
        controller = staleness.StalenessController(2, staleness=1)

        def add_worker(self, worker_id=None, with_generation=False):
            wid, gen = self.controller.register_with_generation(worker_id)
            return type("H", (), {"worker_id": wid})(), gen

    stub = Stub()
    telemetry.enable()
    telemetry.gauge("train.steps_per_s").set(4.0)
    server = ps_transport.PSServer(stub, watchdog=False)
    worker = ps_transport.RemotePSWorker("%s:%d" % server.address, runner=None, worker_id=0,
                                         overlap=False)
    try:
        status = worker.status()
        assert {"registry", "events", "alerts", "recovery", "memory", "kind"} <= set(status)
        screen = _tool("adtop").render(status, "%s:%d" % server.address)
        assert "ps" in screen and "worker" in screen.lower()
    finally:
        worker.close()
        server.close()


# ------------------------------------------------------------ what the child wrote

def test_train_books_the_same_names_as_jax(names_run):
    got = json.loads((names_run() / "names.json").read_text())
    jax_names, port_names = got["jax"], got["port"]
    assert jax_names["spans"] == port_names["spans"]
    assert {"train.dispatch", "train.data_wait", "jit.compile", "runner.run.dispatch",
            "runner.shard_batch", "train.readback_wait"} <= set(port_names["spans"])
    assert set(jax_names["metrics"]) - JAX_ONLY == set(port_names["metrics"]) - PORT_ONLY
    assert {"train.attr.compute", "train.flops_per_s", "train.health.grad_norm",
            "train.steps_per_s", "jit.cache_miss", "mem.owned.params"} <= \
        set(port_names["metrics"])
    assert jax_names["events"] == port_names["events"]


def test_profile_loads_in_adprof_and_calibrates_the_autotuner(names_run, monkeypatch):
    from autodist_tpu_torch.strategy.autotune import _load_calibration
    adprof = _tool("adprof")
    prof_dir = names_run() / "port_profiles"
    [path] = [prof_dir / f for f in os.listdir(prof_dir)]
    doc = adprof.load_profile(str(path))
    assert doc["schema"] == profiling.PROFILE_SCHEMA
    assert any("compute" in line for line in adprof.summarize(doc))
    assert adprof.diff(doc, doc, 5.0)["regressions"] == []
    assert {rec["source"] for rec in doc["programs"].values()} == {"fake-trace"}
    monkeypatch.setenv("AUTODIST_PROFILE_DIR", str(prof_dir))
    calib, source = _load_calibration(None)
    assert source == f"profile:{path.name}" and calib.host_s_per_dispatch


if __name__ == "__main__":
    if sys.argv[1] == "names":
        _names_main(pathlib.Path(sys.argv[2]))
