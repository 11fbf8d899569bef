"""Telemetry exporters: Chrome trace-event JSON and benchmark-logger JSONL.

Two sinks for the two telemetry planes:

- :func:`export_chrome_trace` writes the span ring buffer as a Chrome
  trace-event file (the ``{"traceEvents": [...]}`` object form) that loads in
  ui.perfetto.dev or ``chrome://tracing`` — alongside a ``torch.profiler``
  device trace for a host+device overlay (``utils/tracing.trace`` with
  ``with_host_spans=True`` writes both; see docs/usage/observability.md).
- :func:`emit_metrics` writes the metrics-registry snapshot as JSONL metric
  rows through the existing :mod:`autodist_tpu_torch.utils.benchmark_logger` file
  sink (one ``metric.log`` line per instrument), so registry metrics land in
  the same file scrapers already parse.
"""

import json
from typing import Optional

from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.telemetry import spans as _spans
from autodist_tpu_torch.utils import logging

__all__ = ["export_chrome_trace", "emit_metrics", "sample_device_memory",
           "opt_state_bytes"]


def opt_state_bytes(opt_state) -> int:
    """This process's resident bytes of an optimizer state (a
    ``torch.optim.Optimizer`` or a tree of tensors): each tensor's storage
    counted once. Each process holds one card's share, so a replicated
    state counts its full size and a ZeRO-sharded one ``1/dp`` — the number
    weight-update sharding divides (``train()`` samples it as the
    ``train.opt_state_bytes`` gauge at log boundaries)."""
    from autodist_tpu_torch.telemetry.memplane import _tensors
    seen = set()
    total = 0
    for t in _tensors(opt_state):
        try:
            key = (t.device.type, t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):
            key = id(t)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def chrome_trace_events(since_ns=None, pid: Optional[int] = None,
                        clock_offset_ns: int = 0) -> list:
    """The recorded spans as a list of Chrome trace-event dicts: one ``"M"``
    thread_name metadata event per recorded thread, then one ``"X"``
    (complete) event per span with microsecond ``ts``/``dur`` relative to the
    ring's epoch. ``since_ns`` (a ``time.perf_counter_ns`` stamp) keeps only
    spans that started at/after it — the traced-window filter.

    ``pid`` overrides the lane id (Chrome groups events by pid, so each
    worker exporting under its own lane id merges collision-free) and
    ``clock_offset_ns`` is ADDED to every span timestamp before the µs
    conversion — together they let per-worker exports land on one shared
    timeline with no post-hoc JSON rewriting (the cluster trace plane's
    :mod:`autodist_tpu_torch.telemetry.cluster` computes the offsets)."""
    real_pid, epoch_ns, recorded, thread_names, _, _ = \
        _spans._export_state(since_ns)
    if pid is None:
        pid = real_pid
    events = []
    for tid, name in sorted(thread_names.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for name, tid, t0_ns, dur_ns, args in recorded:
        events.append({
            "name": name,
            "ph": "X",
            "cat": "host",
            # trace-event ts unit: usec
            "ts": (t0_ns - epoch_ns + clock_offset_ns) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": pid,
            "tid": tid,
            "args": args or {},
        })
    return events


def export_chrome_trace(path: str, since_ns=None, pid: Optional[int] = None,
                        clock_offset_ns: int = 0) -> str:
    """Write the span ring buffer to ``path`` as Chrome trace-event JSON;
    returns ``path``. Safe to call repeatedly (each call snapshots the ring);
    an empty ring writes a valid empty trace. ``since_ns`` restricts the
    export to spans started at/after that ``perf_counter_ns`` stamp; ``pid``
    and ``clock_offset_ns`` relabel/rebase the lane for merged multi-worker
    timelines (see :func:`chrome_trace_events`)."""
    doc = {"traceEvents": chrome_trace_events(since_ns, pid=pid,
                                              clock_offset_ns=clock_offset_ns),
           "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    logging.info("Wrote %d host span event(s) to %s",
                 len(doc["traceEvents"]), path)
    return path


def sample_device_memory(opt_state=None) -> int:
    """Sample live-buffer and device-memory gauges into the registry; returns
    the number of gauges written.

    Gauges, per local card from ``torch.cuda.memory_stats()``:
    ``device.live_buffers`` / ``device.live_bytes`` (the caching allocator's
    live allocations and their bytes, summed over the cards — a leak shows
    as monotonic growth across log boundaries), and
    ``device.mem.bytes_in_use.d<i>``, ``device.mem.peak_bytes_in_use.d<i>``
    and ``device.mem.bytes_limit.d<i>`` (the card's total memory). PyTorch
    has no ``jax.live_arrays()``: ``device.live_bytes`` is the allocator's
    count of allocated bytes, which includes tensors Python no longer names
    but the allocator has not freed (the JAX package sums live arrays). A
    process with no card writes no device gauge. With ``opt_state``,
    additionally writes ``train.opt_state_bytes`` (:func:`opt_state_bytes`).

    The memory plane's attribution pass rides the same sample: the live
    bytes are decomposed over the :mod:`~autodist_tpu_torch.telemetry.memplane`
    tag registry into ``mem.owned.{params,opt_state,kv_pages,prefetch,
    snapshots,other}`` gauges (``other`` = live minus claimed, clamped at
    zero) plus the ``mem.pressure`` ratio the shipped ``mem_pressure``
    alert rule thresholds. Called by ``train()`` at log boundaries when
    telemetry is enabled; a diagnostics sampler must never break training,
    so backend hiccups are swallowed at debug level."""
    import torch
    wrote = 0
    live_bytes = 0
    if opt_state is not None:
        try:
            _metrics.gauge("train.opt_state_bytes").set(opt_state_bytes(opt_state))
            wrote += 1
        except (RuntimeError, ValueError, TypeError, AttributeError) as e:
            logging.debug("opt-state byte sampling unavailable: %s", e)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    stats = {}
    for i in range(cards):
        try:
            stats[i] = torch.cuda.memory_stats(i)
        except (RuntimeError, AssertionError) as e:
            logging.debug("device-memory sampling unavailable on card %d: %s", i, e)
    if stats:
        live_bytes = sum(int(st.get("allocated_bytes.all.current", 0)) for st in stats.values())
        _metrics.gauge("device.live_buffers").set(
            sum(int(st.get("allocation.all.current", 0)) for st in stats.values()))
        _metrics.gauge("device.live_bytes").set(live_bytes)
        wrote += 2
    try:
        from autodist_tpu_torch.telemetry import memplane as _memplane
        for owner, nbytes in _memplane.attribute(live_bytes).items():
            _metrics.gauge(f"mem.owned.{owner}").set(int(nbytes))
            wrote += 1
        _memplane.current_pressure(max_age_s=0.0)   # books mem.pressure
        wrote += 1
    except Exception as e:  # noqa: BLE001 — attribution is best-effort
        logging.debug("memory attribution unavailable: %s", e)
    for i, st in stats.items():
        _metrics.gauge(f"device.mem.bytes_in_use.d{i}").set(
            int(st.get("allocated_bytes.all.current", 0)))
        _metrics.gauge(f"device.mem.peak_bytes_in_use.d{i}").set(
            int(st.get("allocated_bytes.all.peak", 0)))
        _metrics.gauge(f"device.mem.bytes_limit.d{i}").set(
            int(torch.cuda.get_device_properties(i).total_memory))
        wrote += 3
    return wrote


_EMIT_LOGGER = None


def emit_metrics(global_step: Optional[int] = None, logger=None,
                 require_file_sink: bool = True) -> int:
    """Emit the registry snapshot through the benchmark-logger sink; returns
    the number of rows written.

    With ``require_file_sink`` (the default) emission is a no-op unless
    ``AUTODIST_BENCHMARK_LOG_DIR`` selects the JSONL file sink — the train
    loop calls this every log period, and mirroring a whole snapshot into the
    console logger each period would be noise, not observability. Histograms
    emit their ``count`` as the value with the full bucket dict in
    ``extras``."""
    global _EMIT_LOGGER
    from autodist_tpu_torch.utils import benchmark_logger
    if logger is None:
        if _EMIT_LOGGER is None:
            candidate = benchmark_logger.get_benchmark_logger()
            if isinstance(candidate, benchmark_logger.BenchmarkFileLogger):
                # Cache ONLY the file sink (one open handle per process). A
                # base-logger result is re-evaluated next call, so setting
                # AUTODIST_BENCHMARK_LOG_DIR later in the process still
                # switches emission on instead of being frozen out forever.
                _EMIT_LOGGER = candidate
            elif require_file_sink:
                return 0
            logger = _EMIT_LOGGER if _EMIT_LOGGER is not None else candidate
        else:
            logger = _EMIT_LOGGER
    return logger.log_metrics(_metrics.snapshot(), global_step=global_step)
