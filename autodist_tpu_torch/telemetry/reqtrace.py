"""Request-scoped distributed tracing: the per-process lifecycle ring.

The span ring (:mod:`autodist_tpu_torch.telemetry.spans`) answers "what did this
THREAD do"; the metrics plane aggregates request latency into histograms.
Neither follows ONE request across the fleet — router queue vs. admission
wait vs. prefill vs. decode cadence vs. a replay after a replica death is
invisible once the request crosses a process boundary. This module records
request lifecycle MARKS — ``(rid, phase, t_ns, args)`` — into a bounded
columnar ring at the points that already know the rid (the router's route
loop, the serving wire arm, the batcher's admission/completion sites), keyed
by the ROUTER-SCOPE rid so marks from different processes join into one
trace (:mod:`autodist_tpu_torch.telemetry.cluster` merges them onto one clock;
``tools/adtrace.py`` renders waterfalls and flow-linked Chrome traces).

Phases (:data:`PHASES`): ``received`` / ``queued`` / ``admitted`` /
``prefill_start`` / ``prefill_end`` / ``first_token`` / ``done`` on the
replica; ``received`` / ``sent`` / ``replayed`` / ``shed`` / ``finished``
on the router. A replayed request repeats ``sent`` with a bumped ``hop``
arg — one rid, one trace, a visible failover.

Cost contract (the :mod:`spans` contract exactly): DISARMED (the default),
:func:`mark` performs one attribute read and returns — the serving hot
paths pay nanoseconds per request, gated by ``bench.py
--reqtrace-overhead``. Armed (``AUTODIST_REQTRACE=1``), a mark costs one
``perf_counter_ns`` read plus, under one uncontended lock, one intern
lookup and four deque appends. The ring is columnar (aligned deques
appended in lockstep) so a full-ring export — the ``reqtrace`` pull opcode
— is a handful of C-speed ``list(deque)`` calls. Rids are stored VERBATIM
(not interned): unlike span names they are unbounded, and an intern table
would leak one entry per request ever seen while the ring forgot the marks.
"""

import collections
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["mark", "enable", "disable", "enabled", "clear", "PHASES",
           "snapshot_marks", "group_records"]

# The vocabulary adtrace renders; marks with other phases still record (the
# ring is a log, not a schema) but the waterfall only prices these.
PHASES = ("received", "queued", "admitted", "prefill_start", "prefill_end",
          "first_token", "done", "shed", "replayed", "sent", "finished")


class _State:
    """Process-global request-trace state. ``enabled`` is THE hot-path gate:
    the disarmed fast path reads this one attribute and nothing else.

    Columnar ring: four aligned deques (rid verbatim, interned phase id,
    t_ns, args) appended in lockstep under the lock; the phase intern table
    is bounded by :data:`PHASES`' size, so memory is bounded by the ring."""

    __slots__ = ("enabled", "phase_ids", "ring_rid", "ring_phase", "ring_t",
                 "ring_args", "lock", "epoch_ns")

    def __init__(self, capacity: int):
        self.enabled = False
        self.phase_ids: Dict[str, int] = {}
        self.ring_rid = collections.deque(maxlen=capacity)
        self.ring_phase = collections.deque(maxlen=capacity)
        self.ring_t = collections.deque(maxlen=capacity)
        self.ring_args = collections.deque(maxlen=capacity)
        self.lock = san_lock()
        # Export offsets mark timestamps against this epoch so offline dumps
        # start near t=0 (same role as the span ring's epoch).
        self.epoch_ns = time.perf_counter_ns()

    def ring_len(self) -> int:
        return len(self.ring_t)


def _ring_capacity() -> int:
    cap = const.ENV.AUTODIST_REQTRACE_RING.val
    return max(1, int(cap))


_STATE = _State(_ring_capacity())


def mark(rid, phase: str, **args):
    """Record one lifecycle mark for request ``rid`` (the router-scope rid
    token where one exists — that key is what joins marks across
    processes). Extra keyword args ride into the record (keep them small
    and wire/JSON-safe: ``hop``, ``replica``, ``wire_ns``...). Disarmed
    cost is a single attribute check."""
    if not _STATE.enabled:
        return
    t = time.perf_counter_ns()
    st = _STATE
    with st.lock:
        pix = st.phase_ids.get(phase)
        if pix is None:
            pix = st.phase_ids[phase] = len(st.phase_ids)
        st.ring_rid.append(rid)
        st.ring_phase.append(pix)
        st.ring_t.append(t)
        st.ring_args.append(args or None)


def enable():
    """Arm request-lifecycle recording for this process."""
    _STATE.enabled = True


def disable():
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def clear():
    """Drop all recorded marks and the phase intern table."""
    with _STATE.lock:
        _STATE.ring_rid.clear()
        _STATE.ring_phase.clear()
        _STATE.ring_t.clear()
        _STATE.ring_args.clear()
        _STATE.phase_ids.clear()
        _STATE.epoch_ns = time.perf_counter_ns()


def _export_columns(since_ns: Optional[int] = None):
    """The raw columnar snapshot, C-speed: ``(pid, epoch_ns, phases_table,
    rids, phase_idx, t_ns, args, wall_ns, perf_ns)``. ``phase_idx`` indexes
    the phase table; ``since_ns`` filters to marks stamped at/after that
    ``perf_counter_ns`` value. ``wall_ns``/``perf_ns`` are one wall/monotonic
    pair sampled back-to-back under the ring lock — the cluster plane maps a
    mark onto the wall clock via ``wall_ns + (t - perf_ns)`` exactly as it
    does for spans."""
    st = _STATE
    with st.lock:
        phases = list(st.phase_ids)
        rids = list(st.ring_rid)
        phase_idx = list(st.ring_phase)
        t_ns = list(st.ring_t)
        args = list(st.ring_args)
        epoch = st.epoch_ns
        wall_ns = time.time_ns()
        perf_ns = time.perf_counter_ns()
    if since_ns is not None and any(t < since_ns for t in t_ns):
        keep = [i for i, t in enumerate(t_ns) if t >= since_ns]
        rids = [rids[i] for i in keep]
        phase_idx = [phase_idx[i] for i in keep]
        t_ns = [t_ns[i] for i in keep]
        args = [args[i] for i in keep]
    return (os.getpid(), epoch, phases, rids, phase_idx, t_ns, args,
            wall_ns, perf_ns)


def snapshot_marks() -> List[Tuple[Any, str, int, Optional[Dict[str, Any]]]]:
    """A point-in-time copy of the ring as ``(rid, phase, t_ns, args)``
    tuples, oldest first (tests and in-process consumers; bulk consumers —
    the ``reqtrace`` opcode — read :func:`_export_columns` directly)."""
    (_, _, phases, rids, phase_idx, t_ns, args, _, _) = _export_columns()
    return [(r, phases[p], t, a)
            for r, p, t, a in zip(rids, phase_idx, t_ns, args)]


def group_records(marks) -> "Dict[Any, List[Tuple[str, int, dict]]]":
    """Group row-wise marks — ``(rid, phase, t_ns, args)`` tuples, or the
    cluster plane's rebased ``{rid, phase, wall_ns, args, ...}`` dicts —
    into one time-ordered ``[(phase, t, args)]`` list per rid. The shared
    assembly step under adtrace's waterfalls and the per-phase breakdown
    tables."""
    out: Dict[Any, List[Tuple[str, int, dict]]] = {}
    for m in marks:
        if isinstance(m, dict):
            rid, phase, t, args = (m.get("rid"), m.get("phase"),
                                   m.get("wall_ns", m.get("t_ns")),
                                   m.get("args") or {})
        else:
            rid, phase, t, args = m[0], m[1], m[2], (m[3] or {})
        out.setdefault(rid, []).append((phase, int(t), dict(args)))
    for recs in out.values():
        recs.sort(key=lambda r: r[1])
    return out


# AUTODIST_REQTRACE=1 arms at import so every entry point (serving replicas
# the router spawns, bench, examples) records without code changes.
if const.ENV.AUTODIST_REQTRACE.val:
    enable()
