"""Host-side span tracing: a thread-aware timeline for the dispatch loop.

``torch.profiler`` answers "what did the DEVICE do"; nothing answered "what did
the HOST do between dispatches" — data wait, feed sharding, gate round-trips,
readback sync. This module records named wall-clock spans into a bounded
in-memory ring buffer, exportable as Chrome trace-event JSON
(:func:`autodist_tpu_torch.telemetry.export_chrome_trace`) that loads in Perfetto
next to the device trace (``docs/usage/observability.md`` shows the overlay
workflow).

Cost contract: when telemetry is DISABLED (the default), :func:`span` performs
exactly one attribute read and returns a shared no-op context manager — the
instrumented hot paths (``runner.run``, the train loop, the PS client) pay
nanoseconds per step, gated in ``bench.py --telemetry-overhead``. When
enabled, a span costs two ``perf_counter_ns`` reads plus, under one
uncontended lock, two intern-table lookups and five deque appends (the ring
is columnar — see :class:`_State` — so full-ring exports are C-speed; that
side is gated by ``bench.py --trace-pull-overhead``).

Spans nest by containment: Chrome's trace viewer stacks same-thread ``"X"``
(complete) events whose time ranges nest, so no explicit parent ids are kept.
"""

import collections
import functools
import os
import threading
import time
from typing import Any, Dict, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["span", "traced", "enable", "disable", "enabled", "clear",
           "snapshot_spans"]


class _State:
    """Process-global telemetry state. ``enabled`` is THE hot-path gate: the
    disabled fast path reads this one attribute and nothing else.

    The ring is COLUMNAR: five aligned deques (interned name id, interned
    tid id, t0, dur, args) appended in lockstep under the lock, with the
    name/tid intern tables alongside. Recording costs a couple of dict
    lookups and five C appends; the payoff is that a FULL-ring export
    (the cluster trace plane's ``trace`` opcode pull) is a handful of
    ``list(deque)``/``np.array`` C calls instead of 65k Python tuple
    visits — ``bench.py --trace-pull-overhead`` gates exactly that."""

    __slots__ = ("enabled", "name_ids", "tid_ids", "ring_name", "ring_tid",
                 "ring_t0", "ring_dur", "ring_args", "thread_names", "lock",
                 "epoch_ns")

    def __init__(self, capacity: int):
        self.enabled = False
        # Intern tables: name/tid -> dense id (insertion-ordered; the export
        # tables are list(...) of the keys). Bounded by the set of distinct
        # span names / threads, like thread_names.
        self.name_ids: Dict[str, int] = {}
        self.tid_ids: Dict[int, int] = {}
        self.ring_name = collections.deque(maxlen=capacity)
        self.ring_tid = collections.deque(maxlen=capacity)
        self.ring_t0 = collections.deque(maxlen=capacity)
        self.ring_dur = collections.deque(maxlen=capacity)
        self.ring_args = collections.deque(maxlen=capacity)
        self.thread_names: Dict[int, str] = {}
        self.lock = san_lock()
        # Export offsets span timestamps against this epoch so traces start
        # near t=0 instead of at an arbitrary monotonic-clock origin.
        self.epoch_ns = time.perf_counter_ns()

    def ring_len(self) -> int:
        return len(self.ring_t0)


def _ring_capacity() -> int:
    cap = const.ENV.AUTODIST_TELEMETRY_RING.val
    return max(1, int(cap))


_STATE = _State(_ring_capacity())


class _NullSpan:
    """The shared disabled-mode context manager / decorator: every method is
    a no-op and ``span()`` returns this one instance, so the disabled cost is
    a single attribute check plus an identity return."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        """No-op twin of :meth:`_Span.set` (disabled mode)."""
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records ``(name, tid, t0_ns, dur_ns, args)`` on exit."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Optional[Dict[str, Any]]):
        self.name = name
        self.args = args
        self._t0 = 0

    def set(self, **args):
        """Merge args onto a LIVE span (recorded at exit) — for values that
        only exist after the span opened, e.g. the request id a serving
        dispatch assigns mid-span. Returns the span for chaining."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = _STATE
        tid = threading.get_ident()
        # Recording takes the state lock: the five ring columns must append
        # in lockstep (a reader between two appends would see misaligned
        # columns), and readers snapshot under the same lock. One uncontended
        # lock + two intern lookups + five C appends per span exit is well
        # inside the enabled-mode budget bench.py --telemetry-overhead
        # tracks.
        with st.lock:
            nid = st.name_ids.get(self.name)
            if nid is None:
                nid = st.name_ids[self.name] = len(st.name_ids)
            tix = st.tid_ids.get(tid)
            if tix is None:
                tix = st.tid_ids[tid] = len(st.tid_ids)
                st.thread_names[tid] = threading.current_thread().name
            st.ring_name.append(nid)
            st.ring_tid.append(tix)
            st.ring_t0.append(self._t0)
            st.ring_dur.append(t1 - self._t0)
            st.ring_args.append(self.args)
        return False


def span(name: str, **args):
    """Record the enclosed block as a named host-timeline span.

    ``with telemetry.span("dispatch"): ...`` — extra keyword arguments ride
    into the Chrome trace event's ``args`` (keep them small and
    JSON-serializable). Disabled mode returns a shared no-op context manager
    after a single attribute check."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, args or None)


def traced(name: Optional[str] = None, **args):
    """Decorator face of :func:`span`: ``@telemetry.traced("load_batch")``
    (or bare ``@telemetry.traced()`` to use the function's qualname). The
    enabled check happens per CALL, so functions decorated at import time
    start recording when telemetry is enabled later."""
    def deco(fn):
        label = name or fn.__qualname__
        span_args = args or None

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _STATE.enabled:
                return fn(*a, **kw)
            with _Span(label, span_args):
                return fn(*a, **kw)
        return wrapper
    return deco


def enable():
    """Turn span recording (and registry mirroring) on for this process."""
    _STATE.enabled = True


def disable():
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def clear():
    """Drop all recorded spans, intern tables, and thread names (the registry
    is separate — see :func:`autodist_tpu_torch.telemetry.registry`)."""
    with _STATE.lock:
        _STATE.ring_name.clear()
        _STATE.ring_tid.clear()
        _STATE.ring_t0.clear()
        _STATE.ring_dur.clear()
        _STATE.ring_args.clear()
        _STATE.name_ids.clear()
        _STATE.tid_ids.clear()
        _STATE.thread_names.clear()
        _STATE.epoch_ns = time.perf_counter_ns()


def _export_columns(since_ns: Optional[int] = None):
    """The raw columnar snapshot, C-speed: ``(pid, epoch_ns, names_table,
    tids_table, name_idx, tid_idx, t0_list, dur_list, args_list,
    thread_names, wall_ns, perf_ns)``. ``name_idx``/``tid_idx`` index the
    two tables; ``since_ns`` filters to spans started at/after that
    ``perf_counter_ns`` stamp.

    ``wall_ns``/``perf_ns`` are one wall-clock / monotonic-clock pair sampled
    back-to-back under the ring lock: span timestamps are monotonic, and the
    cluster trace plane maps them onto the wall clock via
    ``wall_ns + (t0 - perf_ns)`` so rings from different processes can be
    rebased onto one timeline (:mod:`autodist_tpu_torch.telemetry.cluster`)."""
    st = _STATE
    with st.lock:
        names = list(st.name_ids)
        tids = [int(t) for t in st.tid_ids]
        name_idx = list(st.ring_name)
        tid_idx = list(st.ring_tid)
        t0s = list(st.ring_t0)
        durs = list(st.ring_dur)
        args = list(st.ring_args)
        thread_names = dict(st.thread_names)
        epoch = st.epoch_ns
        wall_ns = time.time_ns()
        perf_ns = time.perf_counter_ns()
    if since_ns is not None and any(t0 < since_ns for t0 in t0s):
        keep = [i for i, t0 in enumerate(t0s) if t0 >= since_ns]
        name_idx = [name_idx[i] for i in keep]
        tid_idx = [tid_idx[i] for i in keep]
        t0s = [t0s[i] for i in keep]
        durs = [durs[i] for i in keep]
        args = [args[i] for i in keep]
    return (os.getpid(), epoch, names, tids, name_idx, tid_idx, t0s, durs,
            args, thread_names, wall_ns, perf_ns)


def snapshot_spans():
    """A point-in-time copy of the ring: a list of
    ``(name, tid, t0_ns, dur_ns, args)`` tuples, oldest first."""
    return _export_state()[2]


def _export_state(since_ns: Optional[int] = None):
    """(pid, epoch_ns, spans, thread_names, wall_ns, perf_ns) — the row-wise
    view over :func:`_export_columns` (spans as ``(name, tid, t0_ns, dur_ns,
    args)`` tuples) for the per-process Chrome exporter and
    :func:`snapshot_spans`; bulk consumers (the cluster trace plane) read
    the columns directly."""
    (pid, epoch, names, tids, name_idx, tid_idx, t0s, durs, args,
     thread_names, wall_ns, perf_ns) = _export_columns(since_ns)
    spans = [(names[n], tids[t], t0, dur, a)
             for n, t, t0, dur, a in zip(name_idx, tid_idx, t0s, durs, args)]
    return pid, epoch, spans, thread_names, wall_ns, perf_ns


# AUTODIST_TELEMETRY=1 enables at import so every entry point (examples,
# bench, worker processes the coordinator launches with an inherited env)
# records without code changes.
if const.ENV.AUTODIST_TELEMETRY.val:
    enable()
