"""The port's graftlint (``autodist_tpu_torch.analysis`` and
``python -m autodist_tpu_torch.tools.graftlint``) on the CPU.

- The registry: GL001-GL012 under the JAX package's IDs, GL000 the meta
  check, the same program/full-program split.
- Parity: one fixture tree, written once under the JAX package's paths
  (``autodist_tpu/``, ``tests/test_*.py``) and once under the port's
  (``autodist_tpu_torch/``, ``tests/test_torch_*.py``), gives the same
  (check, line, col) findings, paths mapped, from both analyzers, for GL002,
  GL005 and GL006-GL012.
- PyTorch's hazards, port only: GL001's vocabulary (host reads, synchronizes,
  collectives and work handles, graph replays, ``subprocess``), GL003 (a
  captured graph's outputs read after a later replay), GL004 (host effects
  under a CUDA-graph capture or a ``make_fx`` trace), and GL006 following an
  encoder split into helpers: each flagged, clean and suppressed.
- The CLI: exit codes, JSON, SARIF, baseline, cache, ``--explain``, and
  ``--crosscheck`` on an export the port's sanitizer writes here.
- Self-clean: the CLI with its defaults and committed baseline exits 0.
"""

import json
import pathlib
import textwrap
import threading

import pytest

from autodist_tpu.analysis import core as jax_core
from autodist_tpu_torch.analysis import core
from autodist_tpu_torch.testing import sanitizer
from autodist_tpu_torch.tools import graftlint as cli

REPO = pathlib.Path(__file__).resolve().parents[1]
PARITY_CHECKS = ("GL002", "GL005", "GL006", "GL007", "GL008", "GL009", "GL010", "GL011",
                 "GL012")

# One tree, in the JAX package's layout; _to_port maps it onto the port's.
TREE = {
    "autodist_tpu/const.py": """
        _ENV_DEFAULTS = {
            "AUTODIST_GOOD": 0,
        }
    """,
    "autodist_tpu/svc.py": """
        # graftlint: lock-order=_a_lock->_b_lock
        import threading

        class Service:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()
                self._c_lock = threading.Lock()

            def forward(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def backward(self):
                with self._b_lock:
                    with self._a_lock:
                        pass

            def undeclared(self):
                with self._a_lock:
                    with self._c_lock:
                        pass
    """,
    "autodist_tpu/gate.py": """
        import threading

        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self._ready = threading.Event()

            def wait_open(self):
                with self._cond:
                    self._cond.wait_for(lambda: True)

            def pause(self):
                with self._cond:
                    self._cond.wait(timeout=None)

            def bounded(self):
                self._ready.wait(5.0)
                self._ready.wait()
    """,
    "tests/test_gate.py": """
        import threading

        def test_wait():
            threading.Event().wait()
    """,
    "autodist_tpu/proto.py": """
        import struct

        _HDR = struct.Struct("!Q")
        _FRAME_VERSION = 0

        class Client:
            def push(self, grads):
                return self._client.call("aply", grads)

            def pull(self):
                return self._client.call("read")

        def _dispatch(msg):
            op = msg[0]
            if op == "apply":
                return ("ok",)
            if op == "read":
                return ("ok", 1)
            return ("error", "unknown")

        def _enc(out, obj):
            out += b"z"

        def _dec(r):
            tag = r.take(1)
            if tag == b"y":
                return 1

        def _frame_len(header):
            (word,) = _HDR.unpack(header)
            if word >> 56 != _FRAME_VERSION:
                raise ValueError(word)
            return word

        def sloppy_len(header):
            (word,) = _HDR.unpack(header)
            return word
    """,
    "autodist_tpu/user.py": """
        import os

        GOOD = os.environ.get("AUTODIST_GOOD")
        BAD = os.environ["AUTODIST_GOOD"]
        TYPO = "AUTODIST_TYPO"
    """,
    "tests/test_user.py": """
        import os

        def test_env():
            assert os.environ.get("AUTODIST_GOOD") is None
            assert "AUTODIST_TYPOED" != ""
    """,
    "tests/test_Bad.py": """
        def test_x():
            pass
    """,
    "tests/test_spawns.py": """
        import subprocess

        import pytest

        @pytest.mark.slow
        def test_child():
            subprocess.run(["true"])
    """,
    "autodist_tpu/prod.py": """
        from autodist_tpu import telemetry

        def sample():
            telemetry.gauge("train.mfu").set(0.5)
            telemetry.counter("serve.requests.completed").inc()
            for phase in ("compute", "comm"):
                telemetry.gauge(f"train.attr.{phase}").set(0.1)
    """,
    "autodist_tpu/alerts.py": """
        DEFAULT_RULES = [
            {"name": "mfu_collapse", "kind": "drift", "metric": "train.mfu",
             "ref_from": "window_max", "band": 0.5},
            {"name": "dead", "kind": "drift", "metric": "train.nothing",
             "band": 0.25},
            {"name": "data_wait_drift", "kind": "drift",
             "metric": "train.attr.datawait", "ref_from": "plan", "band": 0.25},
        ]

        def _reference(breakdown):
            return {"compute": breakdown.get("compute_s", 0.0),
                    "data_wait": breakdown.get("data_wait_s", 0.0)}

        def render(reg):
            return reg.get("train.mfu"), reg.get("train.mfuu")
    """,
    "docs/usage/observability.md": "Metrics: `train.mfu`, the `train.attr.*` family.\n",
    "autodist_tpu/res.py": """
        import threading

        class Producer:
            def __init__(self):
                self._t = threading.Thread(target=lambda: None, daemon=True)

            def close(self):
                pass

        def make_feed():
            return Producer()
    """,
    "autodist_tpu/train.py": """
        from autodist_tpu.res import Producer, make_feed

        def leaks():
            feed = make_feed()
            for _ in range(3):
                next(feed)

        def unprotected():
            feed = Producer()
            next(feed)
            feed.close()

        def clean():
            feed = Producer()
            try:
                next(feed)
            finally:
                feed.close()
    """,
    "run.py": """
        from autodist_tpu.res import Producer

        feed = Producer()
    """,
    "autodist_tpu/wiremod.py": """
        IDEMPOTENT_OPS = frozenset({"read", "version", "regster"})

        class PSClient:
            def call_raw(self, msg, counters):
                return msg

            def call(self, *msg):
                return self.call_raw(msg, None)

        def _dispatch(msg):
            op = msg[0]
            if op == "read":
                return ("ok", 1)
            if op == "version":
                return ("ok", 0)
            if op == "register":
                return ("ok",)
            return ("error", "unknown")
    """,
    "autodist_tpu/overlap.py": """
        from autodist_tpu.wiremod import PSClient

        def prefetch(counters):
            client = PSClient()
            good = client.call_raw(("read", 0), counters)
            bad = client.call_raw(("apply", 0), counters)
            stats = client.call("stats")
            return good, bad, stats
    """,
    "autodist_tpu/worker.py": """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._thread = None

            def start(self):
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()

            def _loop(self):
                with self._lock:
                    self._count += 1

            def read(self):
                return self._count
    """,
}


def _to_port(rel):
    if rel.startswith("autodist_tpu/"):
        return "autodist_tpu_torch/" + rel[len("autodist_tpu/"):]
    if rel.startswith("tests/test_"):
        return "tests/test_torch_" + rel[len("tests/test_"):]
    return rel


def _write(root, files):
    for rel, source in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    jax_root = _write(tmp_path_factory.mktemp("jax"), TREE)
    port_root = _write(tmp_path_factory.mktemp("port"), {
        _to_port(rel): src.replace("autodist_tpu", "autodist_tpu_torch")
        for rel, src in TREE.items()})
    return jax_root, port_root


def _findings(pkg_core, root, check, mapped=lambda p: p):
    res = pkg_core.lint_paths([str(root)], root=str(root), checks=[check],
                              context=pkg_core.Context(str(root)))
    return sorted((f.check, mapped(f.path), f.line, f.col) for f in res.findings)


def test_registers_the_twelve_checks_under_jax_ids():
    port, jax = core.all_checks(), jax_core.all_checks()
    assert set(port) == set(jax) == {f"GL{i:03d}" for i in range(1, 13)}
    assert core.META_CHECK == jax_core.META_CHECK == "GL000"
    for attr in ("program", "full_program"):
        assert {c for c, v in port.items() if getattr(v, attr)} == \
            {c for c, v in jax.items() if getattr(v, attr)}


@pytest.mark.parametrize("check", PARITY_CHECKS)
def test_same_findings_as_the_jax_analyzer(trees, check):
    jax_root, port_root = trees
    want = _findings(jax_core, jax_root, check, _to_port)
    got = _findings(core, port_root, check)
    assert got and got == want


# ------------------------------------------------------ PyTorch's hazards

def _lint(tmp_path, source, check, rel="autodist_tpu_torch/mod.py"):
    _write(tmp_path, {rel: source})
    res = core.lint_paths([str(tmp_path / rel)], root=str(tmp_path), checks=[check],
                          context=core.Context(str(tmp_path)))
    return res


GL001_TORCH = """
    import subprocess
    import threading

    import torch
    import torch.distributed as dist

    class Pusher:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition()

        def host_read(self, loss):
            with self._lock:
                return loss.item()

        def collective(self, t):
            with self._lock:
                dist.all_reduce(t)

        def barrier(self):
            with self._lock:
                dist.barrier()

        def handle(self, t):
            work = dist.all_reduce(t, async_op=True)
            with self._lock:
                work.wait()

        def sync(self):
            with self._lock:
                torch.cuda.synchronize()

        def replay(self, graph):
            with self._lock:
                graph.replay()

        def build(self):
            with self._lock:
                subprocess.run(["true"])

        def helper_then_copy(self, t):
            with self._lock:
                return self._to_host(t)

        def _to_host(self, t):
            return t.cpu()

        def clean(self, t):
            with self._cond:
                self._cond.wait(1.0)
            dist.all_reduce(t)
            with self._lock:
                return t + 1

        def suppressed(self):
            # graftlint: disable=GL001(this lock exists to serialize the sync)
            with self._lock:
                torch.cuda.synchronize()
"""


def test_gl001_sees_pytorch_blocking_work(tmp_path):
    res = _lint(tmp_path, GL001_TORCH, "GL001")
    src = textwrap.dedent(GL001_TORCH).splitlines()
    flagged = {src[f.line - 1].strip() for f in res.findings}
    assert len(res.findings) == 8 and flagged == {"with self._lock:"}
    assert {f.scope.split(".")[1] for f in res.findings} == {
        "host_read", "collective", "barrier", "handle", "sync", "replay", "build",
        "helper_then_copy"}
    assert [r for _, r in res.suppressed] == ["this lock exists to serialize the sync"]


GL003_TORCH = """
    import torch

    def misread(step, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(x)
        g.replay()
        first = out
        g.replay()
        return first.sum()

    def in_a_loop(step, xs):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(xs[0])
        losses = []
        for x in xs:
            g.replay()
            losses.append(out)
        return losses

    def cloned(step, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(x)
        g.replay()
        first = out.clone()
        g.replay()
        return first.sum(), out.sum()

    def suppressed(step, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(x)
        first = out[0]
        g.replay()
        return first  # graftlint: disable=GL003(the caller wants the latest step only)
"""


def test_gl003_graph_outputs_read_after_a_later_replay(tmp_path):
    res = _lint(tmp_path, GL003_TORCH, "GL003")
    assert [(f.scope, f.line) for f in res.findings] == [("misread", 11),
                                                         ("in_a_loop", 21)]
    assert "clone" in res.findings[0].message and len(res.suppressed) == 1


GL004_TORCH = """
    import time

    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    class Runner:
        def capture(self, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = self._body(x)
            return g, y

        def _body(self, x):
            print("step")
            loss = (x * 2).sum()
            self.calls += 1
            return loss.item()

        def pure_capture(self, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = torch.relu(x) * 2
            return g, y

    def traced(x):
        t0 = time.perf_counter()  # graftlint: disable=GL004(a trace-time stamp, kept on purpose)
        return x + t0

    def stamped(x):
        return x + time.time()

    graph = make_fx(traced)(torch.ones(2))
    other = make_fx(stamped)(torch.ones(2))
"""


def test_gl004_host_effects_under_capture_and_make_fx(tmp_path):
    res = _lint(tmp_path, GL004_TORCH, "GL004")
    assert [(f.scope, f.line) for f in res.findings] == [
        ("Runner._body", 15), ("Runner._body", 17), ("Runner._body", 18), ("stamped", 31)]
    assert [r for _, r in res.suppressed] == ["a trace-time stamp, kept on purpose"]


def test_gl006_follows_an_encoder_split_into_helpers(tmp_path):
    """The port's wire writes the array tag from ``_enc_tensor``: the tag is
    encoded, and a tag no helper writes still is not."""
    codec = """
        def _enc_tensor(out, t):
            out += b"a"

        def _enc(out, obj):
            if obj is None:
                out += b"N"
            else:
                _enc_tensor(out, obj)

        def _dec(r):
            tag = r.take(1)
            if tag == b"N":
                return None
            if tag == b"a":
                return 1
            if tag == b"q":
                return 2
    """
    res = _lint(tmp_path, codec, "GL006")
    assert len(res.findings) == 1 and "b'q'" in res.findings[0].message
    assert _lint(tmp_path, codec.replace('if tag == b"q":\n                return 2', ""),
                 "GL006").ok


# ------------------------------------------------------------------ the CLI

BAD = """
    import threading

    class Runner:
        def __init__(self, runner):
            self._collective_lock = threading.Lock()
            self._runner = runner

        def step(self, state, batch):
            with self._collective_lock:
                return self._runner.run(state, batch)
"""


def test_cli_exit_codes_json_sarif_and_baseline(tmp_path, capsys):
    bad, good = tmp_path / "bad.py", tmp_path / "good.py"
    bad.write_text(textwrap.dedent(BAD))
    good.write_text("x = 1\n")
    args = ["--no-cache", "--check", "GL001"]
    assert cli.main(["--format", "json", "--no-baseline", *args, str(bad)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is False and payload["findings"][0]["check"] == "GL001"
    assert cli.main(["--format", "json", "--no-baseline", *args, str(good)]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True

    assert cli.main(["--format", "sarif", "--no-baseline", *args, str(bad)]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["version"] == "2.1.0"
    (result,) = sarif["runs"][0]["results"]
    assert result["ruleId"] == "GL001"
    assert result["locations"][0]["physicalLocation"]["region"]["startLine"] == 10

    res = core.lint_paths([str(bad)], root=str(cli.ROOT), checks=["GL001"],
                          context=core.Context(cli.ROOT))
    baseline = tmp_path / "baseline.json"
    core.write_baseline(str(baseline), res.findings)
    assert cli.main(["--baseline", str(baseline), *args, str(bad)]) == 0
    assert "1 baselined" in capsys.readouterr().out
    bad.write_text(textwrap.dedent(BAD) + textwrap.dedent("""
        def again(lock, runner):
            with lock:
                runner.run()
    """))
    assert cli.main(["--baseline", str(baseline), *args, str(bad)]) == 1
    assert cli.main([str(tmp_path / "nope")]) == 2
    assert cli.main(["--explain", "GL003"]) == 0
    assert "replay" in capsys.readouterr().out
    assert cli.main(["--explain", "GL999"]) == 2
    assert cli.main(["--list-checks"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 12


def test_cli_cache_warm_run_hits_the_program_layer(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(textwrap.dedent(BAD))
    argv = ["--format", "json", "--no-baseline", "--cache-dir", str(tmp_path / "cache"),
            str(tmp_path / "bad.py")]
    assert cli.main(argv) == 1
    cold = json.loads(capsys.readouterr().out)
    assert cli.main(argv) == 1
    warm = json.loads(capsys.readouterr().out)
    assert not cold["cache"]["program_hit"] and warm["cache"]["program_hit"]
    assert warm["findings"] == cold["findings"]


# The crosscheck's locks: made armed inside the test, so the sanitizer keys
# them by this file and these names; _in_order is their static order.
# graftlint: lock-order=_edge_a->_edge_b
_edge_a = _edge_b = None


def _make_edge_locks():
    global _edge_a, _edge_b
    _edge_a = sanitizer.san_lock()
    _edge_b = sanitizer.san_lock()


def _in_order():
    with _edge_a:
        with _edge_b:
            pass


def _nest(outer, inner):
    with outer:
        with inner:
            pass


def _reversed():
    # Through parameters: the reverse order is the run's alone, never the
    # source's (a static b -> a nesting would contradict the declaration).
    _nest(_edge_b, _edge_a)


def _export(tmp_path, name, body):
    """Two threads run ``body`` under the armed sanitizer; its export."""
    with sanitizer.armed("locks"):
        _make_edge_locks()
        threads = [threading.Thread(target=body) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        return sanitizer.dump_observed(str(tmp_path / name))


def test_crosscheck_reads_the_port_sanitizers_export(tmp_path, capsys):
    rel = str(pathlib.Path(__file__).relative_to(REPO))
    ordered = _export(tmp_path, "ordered.jsonl", _in_order)
    edges = [json.loads(line) for line in open(ordered)][1:]
    assert [(e["outer"]["name"], e["inner"]["name"]) for e in edges] == \
        [("_edge_a", "_edge_b")]
    assert cli.main(["--crosscheck", "--observed", ordered, rel]) == 0
    out = capsys.readouterr().out
    assert "0 dynamic finding(s), 0 unexercised static edge(s), 1 observed edge(s)" in out

    reverse = _export(tmp_path, "reverse.jsonl", _reversed)
    assert cli.main(["--crosscheck", "--format", "json", "--observed", reverse, rel]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert not payload["ok"] and "opposite of the static nesting" in \
        payload["findings"][0]["message"]
    assert cli.main(["--crosscheck", "--observed", str(tmp_path / "none.jsonl"), rel]) == 2


def test_port_tree_is_lint_clean_against_its_committed_baseline(capsys):
    rc = cli.main([])
    out = capsys.readouterr().out
    assert rc == 0, f"graftlint found new findings:\n{out}"
