"""Tracing and build-stage snapshots (the port's copy of
``autodist_tpu/utils/tracing.py``).

- Chrome-trace timelines map to :func:`trace`, a ``torch.profiler``
  wrapper writing a Chrome trace of the host ops and the card's kernels
  (``device_trace.json``) under the working dir's ``traces/``.
- Graph-evolution snapshots map to :func:`dump_stage`: the FX graph of the
  loss and of the train step, traced on fake tensors (where the JAX package
  writes jaxpr and StableHLO), under ``graphs/<tag>/``.

``trace(..., with_host_spans=True)`` additionally records the host-side
telemetry spans (:mod:`autodist_tpu_torch.telemetry`) for the traced window
and writes them as ``host_spans_w<process-id>.json`` inside the same trace
directory (the AUTODIST_PROCESS_ID suffix keeps per-worker files on a shared
trace dir from overwriting each other) — open ``device_trace.json`` and the
host-span file(s) together in ui.perfetto.dev to see host dispatch/wait
spans next to the kernels. The two traces use different clock origins, so
align on a recognizable boundary rather than absolute timestamps; for a
CLOCK-ALIGNED multi-worker host timeline use
``telemetry.collect_cluster_trace`` instead.
"""

import contextlib
import itertools
import os
import time
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

# Monotonic per-process suffix for default trace dirs: a wall-clock-second
# name alone collides when two traces start within the same second (the
# second trace silently wrote into — and interleaved with — the first's dir).
_TRACE_SEQ = itertools.count()


def _unique_trace_dir(name: str) -> str:
    """Collision-free default trace directory under the working dir."""
    return os.path.join(const.DEFAULT_TRACE_DIR,
                        f"{name}_{int(time.time())}_{next(_TRACE_SEQ):03d}")


@contextlib.contextmanager
def trace(name: str = "trace", trace_dir: Optional[str] = None,
          with_host_spans: bool = False):
    """Profile the enclosed steps: ``with tracing.trace(): runner.run(...)``.

    Writes ``<trace_dir>/device_trace.json``, the ``torch.profiler`` Chrome
    trace of the window (host ops, and every kernel the card ran when a card
    is present), viewable in ui.perfetto.dev. With ``with_host_spans=True``,
    telemetry span recording is enabled for the window and the host timeline
    is written to ``<trace_dir>/host_spans_w<process-id>.json`` on exit
    (telemetry returns to its prior enabled/disabled state afterwards; the
    per-process name keeps workers sharing a trace dir from colliding) —
    load both files in Perfetto for a host+device overlay (see module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    trace_dir = trace_dir or _unique_trace_dir(name)
    os.makedirs(trace_dir, exist_ok=True)
    logging.info("Writing profiler trace to %s", trace_dir)
    if with_host_spans:
        from autodist_tpu_torch import telemetry
        was_enabled = telemetry.enabled()
        # Window stamp BEFORE enabling: host_spans.json carries only spans
        # started inside this trace window, not whatever an earlier window
        # (or an always-enabled process) left in the ring.
        window_start_ns = time.perf_counter_ns()
        telemetry.enable()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities) as prof:
            yield trace_dir
        prof.export_chrome_trace(os.path.join(trace_dir, "device_trace.json"))
    finally:
        if with_host_spans:
            if not was_enabled:
                telemetry.disable()
            telemetry.export_chrome_trace(
                os.path.join(
                    trace_dir,
                    f"host_spans_w{const.ENV.AUTODIST_PROCESS_ID.val}.json"),
                since_ns=window_start_ns)


def _flatten(tree, out):
    """The tensors of a dict/list/tuple tree (a ``MicroBatched``-style
    wrapper with a ``value`` tensor counts as that tensor), in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in tree:
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(getattr(tree, "value", None), torch.Tensor):
        out.append(tree.value)
    return out


def _rebuild(tree, leaves):
    import torch
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        out = type(tree)({k: _rebuild(v, leaves) for k, v in tree.items()})
        if type(tree) is not dict:   # a laid-out batch keeps its attributes
            vars(out).update(vars(tree))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if isinstance(getattr(tree, "value", None), torch.Tensor):
        return type(tree)(next(leaves))
    return tree


def dump_stage(tag: str, stage: str, fn, *example_args,
               dump_dir: Optional[str] = None) -> Optional[str]:
    """Write the FX graph of ``fn(*example_args)`` for one build stage to
    ``<dump_dir>/<stage>.fx.txt``; returns the path without its suffix, or
    None when the trace failed.

    Stages mirror the JAX package's: "0-original" (the user's loss) and
    "1-distributed" (the train step). ``fn`` is traced with ``make_fx`` on
    FAKE CPU tensors of the example tensors' shapes and dtypes: nothing runs,
    no memory is copied, and no real tensor is touched, so tracing a step
    (an optimizer update, collectives) leaves the state as it was.
    ``example_args`` are trees of tensors (real or meta)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    import torch
    dump_dir = dump_dir or os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, tag)
    os.makedirs(dump_dir, exist_ok=True)
    base = os.path.join(dump_dir, stage)
    try:
        flat = _flatten(list(example_args), [])
        with FakeTensorMode():
            fakes = [torch.empty(tuple(t.shape), dtype=t.dtype).requires_grad_(t.requires_grad)
                     for t in flat]

        def flat_fn(*leaves):
            return fn(*_rebuild(list(example_args), iter(leaves)))

        graph = make_fx(flat_fn, tracing_mode="fake")(*fakes)
        with open(base + ".fx.txt", "w") as f:
            f.write(graph.print_readable(print_output=False))
        logging.debug("Dumped %s stage %s", tag, stage)
        return base
    except Exception as e:  # diagnostics must never break training
        logging.warning("Stage dump %s/%s (dump path %s.*) failed: %s",
                        tag, stage, base, e)
        return None
