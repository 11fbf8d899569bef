"""The port's operator tools (``autodist_tpu_torch.tools``) against the JAX
package's ``tools/``, on the same inputs, on the CPU.

The JAX tools are loaded by path (as ``test_torch_telemetry.py`` loads
them); each pair must agree string for string or dict for dict:
- ``adtop.render`` of a port ``PSServer`` status, a port ``InferenceServer``
  status and a synthetic status that takes every branch;
- ``adfleet.render`` of a fleet polled from a port ``RouterServer`` over two
  tiny CPU replicas (model-free engines), and ``adtrace``'s table,
  waterfalls, report and Chrome trace of the reqtrace rings the port's
  ``discover``/``collect`` pulled from it;
- ``adprof`` ``summarize``, ``diff`` and ``--predict`` on profiles the
  port's attribution plane wrote;
- ``tracedump.merge_dumps`` on the port's span, event and reqtrace dumps;
- each CLI's flags, and ``parallel_tests.shard_files`` on a fixed file list.
Clocks are frozen where a screen prints one (``time.strftime``).
"""

import argparse
import functools
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.serving import (Batcher, InferenceServer, Router, RouterServer,
                                        ServeClient, ServeConfig, default_buckets)
from autodist_tpu_torch.telemetry import profiling, reqtrace
from autodist_tpu_torch.tools import (adfleet, adprof, adtop, adtrace, graftlint,
                                      parallel_tests, tracedump)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ("adtop", "adfleet", "adprof", "adtrace", "tracedump", "graftlint", "parallel_tests")
PORT = {"adtop": adtop, "adfleet": adfleet, "adprof": adprof, "adtrace": adtrace,
        "tracedump": tracedump, "graftlint": graftlint, "parallel_tests": parallel_tests}


@functools.cache
def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _frozen_clock_and_planes_off(monkeypatch):
    """Screens print the wall clock: freeze it. Leave the port's planes off
    and empty, as found."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    yield
    telemetry.disable()
    telemetry.clear()
    profiling.disable()
    profiling.reset()
    reqtrace.disable()
    reqtrace.clear()


class FakeEngine:
    """A model-free engine: deterministic tokens, no weights."""

    def __init__(self, capacity=2, max_len=32):
        self.capacity, self.max_len = capacity, max_len
        self.buckets = default_buckets(max_len)
        self._steps = np.zeros(capacity, np.int64)

    def make_keys(self, seed, n):
        return None

    def admit(self, slot, prompt, key):
        self._steps[slot] = 0
        return 100 * slot

    def step(self, keys):
        self._steps += 1
        return (100 * np.arange(self.capacity) + self._steps).astype(np.int32)

    def free(self, slot):
        pass


def _replica():
    return InferenceServer(Batcher(FakeEngine(), ServeConfig(max_batch=2, max_queue=8)),
                           port=0)


def _addr(server):
    return "%s:%d" % tuple(server.address)


# ------------------------------------------------------------------ adtop

SYNTHETIC = {
    "kind": "serve", "uptime_s": 4000.0, "error": "refused",
    "wire": {"bytes_sent": 1234, "msgs_sent": 3, "bytes_received": 99, "msgs_received": 2},
    "capacity": 4, "queue_depth": 1, "mode": "continuous", "engine": "paged",
    "in_flight": [{"request_id": 7, "slot": 1, "age_s": 0.5, "tokens": 3, "prompt_len": 9}],
    "registry": {
        "ps.wire.bytes_saved": 4096, "ps.wire.bytes_quantized": 8192, "wire.quantize_s": 0.25,
        "serve.requests.completed": 5, "serve.requests.rejected": 1,
        "serve.latency_s.total": {"le:0.01": 2, "le:0.1": 5, "le:+Inf": 5, "count": 5,
                                  "sum": 0.2},
        "serve.kv.pages_used": 3, "serve.kv.pages_free": 13, "serve.kv.prefix_hits": 2,
        "serve.kv.prefix_misses": 1, "train.mfu": 0.283, "train.membw_util": 0.41,
        "train.attr.compute": 0.61, "train.attr.comm": 0.05, "train.attr.host": 0.22,
        "serve.attr.wire": 0.1, "serve.attr.queue": 0.2, "serve.attr.prefill": 0.3,
        "serve.attr.decode": 0.4, "train.health.grad_norm": 1.5},
    "alerts": {"action": "warn", "resolved": [{"rule": "old"}],
               "active": [{"rule": "serve_p99_burn", "for_s": 12.0, "fired_t_wall_s": 1.0,
                           "burn": 3.5, "exemplar": {"rid": "r-9"}}]},
    "recovery": {"counts": {"evicted": 1, "rejoined": 1}, "generations": {"0": 2},
                 "evictions": [{"worker": 0, "t_wall_s": 1.0}], "rejoins": [{"worker": 0}]},
    "memory": {"live_bytes": 3 << 30, "pressure": 0.5, "budget_bytes": 6 << 30,
               "budget_source": "measured", "owned": {"params": 1 << 20, "other": 0}},
    "events": [{"name": "health.anomaly", "t_wall_s": 1.0, "kind": "spike"},
               {"name": "watchdog.stall", "worker": 1}],
}


def _ps_status():
    from autodist_tpu_torch.parallel import ps_transport, staleness
    from autodist_tpu_torch.runner import TrainState

    class Stub:
        service = staleness.ParameterService(
            TrainState(step=0, params={"w": torch.zeros(3)}, optimizer=None), lambda s, g: s)
        controller = staleness.StalenessController(2, staleness=1)

        def add_worker(self, worker_id=None, with_generation=False):
            wid, gen = self.controller.register_with_generation(worker_id)
            return type("H", (), {"worker_id": wid})(), gen

    telemetry.enable()
    telemetry.gauge("train.steps_per_s").set(4.0)
    telemetry.gauge("train.attr.compute").set(0.75)
    server = ps_transport.PSServer(Stub(), watchdog=False)
    worker = ps_transport.RemotePSWorker(_addr(server), runner=None, worker_id=0,
                                         overlap=False)
    try:
        return adtop.fetch_status(_addr(server)), _addr(server)
    finally:
        worker.close()
        server.close()


def _serve_status():
    telemetry.enable()
    server = _replica()
    try:
        client = ServeClient(server.address)
        try:
            for seed in range(3):
                client.generate(np.arange(1, 5), 3, seed=seed)
        finally:
            client.close()
        return adtop.fetch_status(_addr(server)), _addr(server)
    finally:
        server.close()


@pytest.mark.parametrize("which", ["ps", "serve", "synthetic"])
def test_adtop_render_equals_jax(which):
    status, address = {"ps": _ps_status, "serve": _serve_status,
                       "synthetic": lambda: (SYNTHETIC, "h:1")}[which]()
    screen = adtop.render(status, address)
    assert screen == _jax_tool("adtop").render(status, address)
    head = {"ps": "ps server", "serve": "serve server", "synthetic": "serve server"}[which]
    assert head in screen.splitlines()[0]
    if which == "ps":
        assert "gate     bound 1" in screen and "w0" in screen
    if which == "synthetic":
        assert "exemplar r-9" in screen and "recover  evicted 1" in screen


# ------------------------------------------------- the fleet: adfleet, adtrace

@pytest.fixture
def fleet():
    """A RouterServer over two replicas, 6 requests served with the request
    trace plane armed; yields (router address, requests served). The
    process-wide registry starts empty: another test's router or replicas
    in this process leave their counts and events there."""
    _recovery.reset()
    telemetry.registry().clear()
    telemetry.enable()
    reqtrace.enable()
    router = Router(_replica, n_replicas=2, start=False)
    server = RouterServer(router)
    try:
        client = ServeClient(server.address)
        try:
            for seed in range(6):
                client.generate(np.arange(1, 4), 3, seed=seed)
        finally:
            client.close()
        yield _addr(server), 6
    finally:
        server.close()


def test_adfleet_and_adtrace_equal_jax_on_a_port_router(fleet, tmp_path):
    router, served = fleet
    endpoints = adtrace.discover([router])
    assert len(endpoints) == 3 and endpoints[0] == router
    polled = adfleet.fetch_fleet(endpoints)
    assert set(polled) == set(endpoints) and all("kind" in s for s in polled.values())
    screen = adfleet.render(polled)
    assert screen == _jax_tool("adfleet").render(polled)
    assert f"routed {served}" in screen and "replicas 2/2 up" in screen

    got = adtrace.collect(endpoints, with_spans=True)
    assert not got["errors"]
    jax_adtrace = _jax_tool("adtrace")
    states = got["states"]
    report = adtrace.render_report(states, top=2)
    assert report == jax_adtrace.render_report(states, top=2)
    assert f"{served} completed request(s)" in report.splitlines()[0]
    marks = adtrace.merged_marks(states)
    assert marks == jax_adtrace.merged_marks(states)
    durations = adtrace.phase_durations(marks)
    assert durations == jax_adtrace.phase_durations(marks)
    assert adtrace.render_table(durations) == jax_adtrace.render_table(durations)
    grouped = reqtrace.group_records(marks)
    rid = next(iter(grouped))
    assert adtrace.render_waterfall(rid, grouped[rid]) == \
        jax_adtrace.render_waterfall(rid, grouped[rid])
    port_out = adtrace.write_chrome_trace(str(tmp_path / "port.json"), states,
                                          got["span_states"])
    jax_out = jax_adtrace.write_chrome_trace(str(tmp_path / "jax.json"), states,
                                             got["span_states"])
    assert json.loads(pathlib.Path(port_out).read_text()) == \
        json.loads(pathlib.Path(jax_out).read_text())


def test_console_clis_read_a_live_router(fleet, capsys):
    router, served = fleet
    assert adfleet.main([router, "--once"]) == 0
    assert "router" in capsys.readouterr().out
    assert adfleet.main(["127.0.0.1:1", "--once", "--timeout", "0.2"]) == 1
    capsys.readouterr()
    assert adtop.main([router, "--raw"]) == 0
    assert json.loads(capsys.readouterr().out)["kind"] == "router"
    assert adtrace.main([router, "--top", "1"]) == 0
    assert f"{served} completed" in capsys.readouterr().out


# ------------------------------------------------------------ adprof

def _port_profile(path, step_s):
    """A profile the port's attribution plane writes: one program with its
    costs, two periods of ``step_s`` a step."""
    profiling.reset()
    profiling.enable()
    profiling.record_program_cost("sig0", "step", 1,
                                  {"flops": 2.0e9, "bytes_accessed": 4.0e6,
                                   "output_bytes": 1024, "temp_bytes": 2048})
    for step in (1, 2):
        profiling.note_dispatch("sig0", "step")
        with telemetry.span("train.dispatch"):
            time.sleep(step_s)
        profiling.observe_period(step=step)
    out = profiling.write_profile(str(path))
    profiling.disable()
    return out


def test_adprof_summarize_diff_and_predict_equal_jax(tmp_path, capsys):
    telemetry.enable()
    base = _port_profile(tmp_path / "base.json", 0.002)
    doc = adprof.load_profile(base)
    slow = json.loads(pathlib.Path(base).read_text())
    slow["summary"]["step_s"] *= 2.0
    new = tmp_path / "new.json"
    new.write_text(json.dumps(slow))
    jax_adprof = _jax_tool("adprof")
    assert adprof.load_profile(base) == jax_adprof.load_profile(base)
    assert adprof.summarize(doc) == jax_adprof.summarize(doc)
    assert adprof.diff(doc, slow, 10.0) == jax_adprof.diff(doc, slow, 10.0)
    assert adprof.diff(doc, slow, 10.0)["regressed"]
    assert adprof.diff(doc, doc, 10.0)["regressions"] == []
    for argv, rc in (([base, "--predict"], 0), ([base, base], 0), ([base, str(new)], 1),
                     ([base, "--predict", "--json"], 0), ([str(tmp_path / "no.json")], 2)):
        assert adprof.main(argv) == rc
        port_out = capsys.readouterr()
        assert jax_adprof.main(argv) == rc
        assert port_out == capsys.readouterr()


# ------------------------------------------------------------ tracedump

def test_tracedump_merges_like_jax(tmp_path, capsys):
    telemetry.enable()
    reqtrace.enable()
    with telemetry.span("train.dispatch", step=1):
        with telemetry.span("runner.run.dispatch"):
            time.sleep(0.001)
    telemetry.event("health.anomaly", kind="nonfinite", step=1)
    reqtrace.mark("r1", "received", wire_ns=1000)
    reqtrace.mark("r1", "finished")
    spans = [telemetry.dump_spans_jsonl(str(tmp_path / f"w{w}.jsonl"), worker_id=w)
             for w in (0, 1)]
    events = telemetry.dump_events_jsonl(str(tmp_path / "events.jsonl"))
    marks = telemetry.dump_reqtrace_jsonl(str(tmp_path / "req.jsonl"), worker_id=1)
    kw = dict(offsets={1: 250000}, event_files=[events], reqtrace_files=[marks])
    port = tracedump.merge_dumps(str(tmp_path / "port.json"), spans, **kw)
    jax = _jax_tool("tracedump").merge_dumps(str(tmp_path / "jax.json"), spans, **kw)
    merged = json.loads(pathlib.Path(port).read_text())
    assert merged == json.loads(pathlib.Path(jax).read_text())
    assert len({e["pid"] for e in merged["traceEvents"] if e["ph"] == "X"}) == 2
    argv = [str(tmp_path / "cli.json"), *spans, "--offset", "1:250000", "--events", events]
    assert tracedump.main(argv) == 0
    assert "2 lane(s)" in capsys.readouterr().out


# ------------------------------------------------------------ the CLIs

class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """Every argument the CLI's parser declares, positional or optional."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return sorted((tuple(a.option_strings) or (a.dest,), a.nargs, a.default is None)
                  for a in seen["parser"]._actions)


@pytest.mark.parametrize("name", TOOLS)
def test_each_cli_has_the_jax_flags(name, monkeypatch):
    assert _flags(PORT[name].main, monkeypatch) == \
        _flags(_jax_tool(name).main, monkeypatch)


def test_shard_files_equals_jax_on_a_fixed_list(tmp_path, monkeypatch):
    files = []
    for i, size in enumerate((500, 40, 300, 300, 7, 900, 120)):
        f = tmp_path / f"test_torch_{i}.py"
        f.write_text("#" * size)
        files.append(str(f))
    assert all(pathlib.Path(f).name.startswith("test_torch_")
               for shard in parallel_tests.shard_files(2) for f in shard)
    jax_pt = _jax_tool("parallel_tests")
    monkeypatch.setattr(jax_pt.glob, "glob", lambda pattern: list(files))
    for n in (1, 3, 4, 10):
        assert parallel_tests.shard_files(n) == jax_pt.shard_files(n)
