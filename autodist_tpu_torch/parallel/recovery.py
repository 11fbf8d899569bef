"""Chief-side recovery plane (the port's copy of
``autodist_tpu/parallel/recovery.py``): the policy layer that makes
detectors ACT.

PRs 5/8/11 built the detection substrate — the PS watchdog flags stalls
(``ps.anomaly.*``), the health monitors flag sick numerics
(``health.anomaly``), the alert engine fires on drift, and the flight
recorder snapshots the evidence — but until this module the only actions
anywhere were warn, record and halt, and the coordinator hard-killed the
chief on any worker exit (the reference's fail-fast ``coordinator.py:98-110``
faithfully reproduced). At pod scale machine loss is routine, not
exceptional (Scale MLPerf-0.6 pods, arXiv 1909.09756); this module closes
the detect→act loop:

- **Auto-eviction** (:func:`evict`): the watchdog retires a worker whose
  stall outlasts ``AUTODIST_EVICT_AFTER_S`` from the staleness gate, so the
  live workers resume instead of parking at the bound forever. The evicted
  worker's parked gate RPC fails typed
  (:class:`~autodist_tpu_torch.parallel.staleness.WorkerEvicted`), and the client
  auto-rejoins — a wrongly-evicted victim recovers on its own.
- **Rejoin bookkeeping** (:func:`log_rejoin`): a replacement (or wrongly
  evicted) worker re-registers, seeded at the slowest live step count, and
  catches up on the chief's LIVE params over ``read_min`` — checkpoint-free.
- **Rollback** (:class:`SnapshotRing` + :func:`rollback`): under
  ``AUTODIST_HEALTH_ACTION=recover`` (or ``AUTODIST_ALERT_ACTION=recover``)
  ``train()`` keeps a bounded in-memory ring of last-known-good states taken
  at health-clean log boundaries; an anomaly rolls back to the newest good
  one and resumes, bounded by ``AUTODIST_RECOVER_MAX`` attempts before
  escalating to the existing halt.
- **Respawn backoff** (:func:`backoff_s`): the coordinator's
  ``AUTODIST_WORKER_FAILURE=respawn`` policy relaunches a dead worker with
  bounded exponential backoff instead of ``os._exit(1)``.

Everything the plane DOES is booked: ``recover.{evicted,rejoined,rollback,
respawn}`` counters + structured events in the shared registry, a bounded
in-process :func:`recovery_snapshot` the ``status`` opcode ships (rendered
by ``adtop``/``adfleet``), and flight-recorder snapshots through the
debounce. The module is deliberately torch-free and import-light — policy,
not mechanism; the gate/transport/train loop own the mechanisms.
"""

import collections
import random
import threading
import time
from typing import Any, Dict, List, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["SnapshotRing", "evict", "rollback", "backoff_s",
           "log_eviction", "log_rejoin", "log_rollback", "log_respawn",
           "recovery_snapshot", "reset"]

# Bounded per-category record retention in the in-process log (the status
# opcode ships these; counts are unbounded counters).
KEEP_RECORDS = 16

# Membership eviction categories: "stall" = the watchdog's autonomous act,
# "disconnect" = the transport observed the worker's socket die (crash OR
# clean close — indistinguishable at the server, both retire the slot).
EVICT_KINDS = ("stall", "disconnect")


def _counter(name: str):
    from autodist_tpu_torch.telemetry import metrics as _metrics
    return _metrics.counter(name)


def _event(name: str, **fields):
    from autodist_tpu_torch.telemetry import metrics as _metrics
    _metrics.event(name, **fields)


class _RecoveryLog:
    """Process-global, lock-guarded record of every recovery action — the
    ``recovery`` section of the ``status`` opcode. Bounded deques per
    category; total counts survive the deque bound."""

    def __init__(self):
        self._lock = san_lock()
        self._evictions = collections.deque(maxlen=KEEP_RECORDS)
        self._rejoins = collections.deque(maxlen=KEEP_RECORDS)
        self._rollbacks = collections.deque(maxlen=KEEP_RECORDS)
        self._respawns = collections.deque(maxlen=KEEP_RECORDS)
        self._counts = {"evicted": 0, "rejoined": 0, "rollbacks": 0,
                        "respawns": 0}
        # Per-worker membership generation as LAST observed by this plane
        # (the staleness gate's occupancy generation at the worker's most
        # recent rejoin) — the status section's membership fingerprint.
        self._generations: Dict[int, int] = {}

    def add(self, category: str, dq_name: str, record: Dict[str, Any]):
        record = dict(record, t_wall_s=round(time.time(), 3))
        with self._lock:
            getattr(self, dq_name).append(record)
            self._counts[category] += 1
        return record

    def note_generation(self, worker_id, generation: int):
        # PS gate slots use numeric ids; the serving fleet router books its
        # replicas by "host:port". Normalize int-able ids (so PS records
        # keep their historical int keys) and keep the rest as strings.
        try:
            worker_id = int(worker_id)
        except (TypeError, ValueError):
            worker_id = str(worker_id)
        with self._lock:
            self._generations[worker_id] = int(generation)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"evictions": list(self._evictions),
                    "rejoins": list(self._rejoins),
                    "rollbacks": list(self._rollbacks),
                    "respawns": list(self._respawns),
                    "counts": dict(self._counts),
                    "generations": dict(sorted(self._generations.items(),
                                               key=lambda kv: str(kv[0])))}


_LOG = _RecoveryLog()


def reset():
    """Fresh log (tests only — the log is additive for the process's life)."""
    global _LOG
    _LOG = _RecoveryLog()


def recovery_snapshot() -> Dict[str, Any]:
    """The ``status`` opcode's ``recovery`` section: bounded recent records
    per category, total counts, per-worker membership generations. A stable
    empty shell when nothing ever acted — pollers keep one schema."""
    return _LOG.snapshot()


# ---------------------------------------------------------------- bookkeeping

def log_eviction(worker_id, kind: str = "stall",
                 age_s: Optional[float] = None) -> Dict[str, Any]:
    """Book one gate eviction (counter + bounded record; watchdog-driven
    ``stall`` evictions additionally emit a ``recover.evicted`` event —
    disconnect retires fire on every clean teardown too, and an event per
    normal close would drown the ring)."""
    _counter("recover.evicted").inc()
    rec = {"worker": worker_id, "kind": kind}
    if age_s is not None:
        rec["age_s"] = round(float(age_s), 3)
    rec = _LOG.add("evicted", "_evictions", rec)
    if kind == "stall":
        _event("recover.evicted", **{k: v for k, v in rec.items()
                                     if k != "t_wall_s"})
    return rec


def log_rejoin(worker_id, generation: int,
               seeded_step: Optional[int] = None) -> Dict[str, Any]:
    """Book one membership rejoin (a previously-retired slot re-registered,
    seeded at the slowest live step count)."""
    _counter("recover.rejoined").inc()
    _LOG.note_generation(worker_id, generation)
    rec = {"worker": worker_id, "generation": int(generation)}
    if seeded_step is not None:
        rec["seeded_step"] = int(seeded_step)
    rec = _LOG.add("rejoined", "_rejoins", rec)
    _event("recover.rejoined", **{k: v for k, v in rec.items()
                                  if k != "t_wall_s"})
    return rec


def log_rollback(from_step, to_step: int, attempt: int) -> Dict[str, Any]:
    """Book one recover-action rollback (bad state discarded, last-known-good
    re-adopted)."""
    _counter("recover.rollback").inc()
    rec = _LOG.add("rollbacks", "_rollbacks",
                   {"from_step": from_step, "to_step": int(to_step),
                    "attempt": int(attempt)})
    _event("recover.rollback", **{k: v for k, v in rec.items()
                                  if k != "t_wall_s"})
    return rec


def log_respawn(address: str, attempt: int,
                backoff: float) -> Dict[str, Any]:
    """Book one coordinator worker respawn."""
    _counter("recover.respawn").inc()
    rec = _LOG.add("respawns", "_respawns",
                   {"address": str(address), "attempt": int(attempt),
                    "backoff_s": round(float(backoff), 3)})
    _event("recover.respawn", **{k: v for k, v in rec.items()
                                 if k != "t_wall_s"})
    return rec


# -------------------------------------------------------------------- actions

def backoff_s(attempt: int, base_s: float, cap_s: float = 30.0) -> float:
    """Jittered bounded exponential backoff: ``min(cap, base * 2^attempt)``
    scaled by a uniform [0.5, 1.0) jitter so a fleet of retriers never
    thunders in lockstep. Always <= ``cap_s`` (bounded — GL005's spirit)."""
    if base_s <= 0.0:
        return 0.0
    return min(float(cap_s), float(base_s) * (2.0 ** max(0, int(attempt)))) \
        * random.uniform(0.5, 1.0)


def evict_after_s() -> Optional[float]:
    """The armed auto-eviction threshold, or None when the policy is off
    (``AUTODIST_EVICT_AFTER_S`` unset/0 — detection stays warn-only)."""
    val = const.env_float(const.AUTODIST_EVICT_AFTER_S, 0.0)
    return val if val > 0.0 else None


def evict(controller, worker_id, kind: str = "stall",
          age_s: Optional[float] = None, server=None) -> Dict[str, Any]:
    """Retire ``worker_id`` from the staleness gate NOW and book the act:
    the frozen step count stops pinning ``min(steps)`` (live workers parked
    at the bound resume), the worker's own parked gate RPC fails typed
    (``WorkerEvicted`` — the client's cue to rejoin), and an armed flight
    recorder snapshots the moment through its debounce.

    The retire is unconditional (no generation token): the eviction evidence
    is seconds of silence, and the tiny race against a concurrent re-register
    self-heals — the evicted client's next gate call raises ``WorkerEvicted``
    and it rejoins automatically. Returns the booked record, or None when
    the worker was already retired (nothing to book — counts track gate
    ACTIONS, never no-ops)."""
    if not controller.retire(worker_id):
        logging.info("recover: worker %s already retired; eviction is a "
                     "no-op", worker_id)
        return None
    rec = log_eviction(worker_id, kind=kind, age_s=age_s)
    logging.warning(
        "recover: EVICTED worker %s from the staleness gate (%s%s) — live "
        "workers resume; the worker may rejoin via register", worker_id,
        kind, f", silent {age_s:.1f}s" if age_s is not None else "")
    from autodist_tpu_torch.telemetry import recorder as _recorder
    _recorder.maybe_record(f"recover.evict.w{worker_id}", server=server)
    return rec


class SnapshotRing:
    """Bounded in-memory ring of last-known-good ``(step, state)`` pairs.

    ``train()`` pushes at every log boundary that closed HEALTHY (no anomaly
    raised, no alert fired). ``copy_fn`` is applied to each pushed state —
    the port's runners update their state IN PLACE, so a bare reference
    would change under the ring; ``train()`` supplies a deep copy on the
    state's device. ``keep`` bounds
    the pinned device memory to K extra states; the default 2 keeps one
    boundary of slack for a SLOW-BURN anomaly — when a rollback to the
    newest snapshot fails again at the same incident, :func:`rollback`
    calls :meth:`drop_newest` and the retry lands one boundary deeper.
    Single-threaded by contract (the train loop is the only caller)."""

    DEFAULT_KEEP = 2

    def __init__(self, keep: int = DEFAULT_KEEP, copy_fn=None):
        self.keep = max(1, int(keep))
        self._copy = copy_fn
        self._ring: List[Any] = []   # (step, state), oldest first

    def push(self, step: int, state):
        if self._copy is not None:
            state = self._copy(state)
        if self._ring and self._ring[-1][0] == step:
            self._ring[-1] = (step, state)   # boundary replayed post-rollback
            return
        self._ring.append((int(step), state))
        del self._ring[:max(0, len(self._ring) - self.keep)]

    def newest(self):
        """``(step, state)`` of the newest good snapshot, or None."""
        return self._ring[-1] if self._ring else None

    def checkout(self):
        """``(step, state)`` of the newest good snapshot with the state
        COPIED back out (``copy_fn`` again) — the resumed loop updates the
        state it is handed in place, and a second rollback to the same
        snapshot must find the ring entry unchanged. None when empty."""
        if not self._ring:
            return None
        step, state = self._ring[-1]
        return (step, self._copy(state) if self._copy is not None else state)

    def states(self) -> List[Any]:
        """The retained snapshot states, oldest first — the memory plane's
        census input (``memplane.tag("snapshots", ring.states())``): the
        ring's deep copies are pinned device memory no other owner claims."""
        return [state for _, state in self._ring]

    def drop_newest(self):
        """Discard the newest snapshot — it was rolled back to and the SAME
        incident fired again, so it is suspect (a slow-burn anomaly already
        latent at capture time); the next checkout lands one boundary
        deeper. An empty ring afterwards means escalation."""
        if self._ring:
            self._ring.pop()

    def __len__(self) -> int:
        return len(self._ring)


def recover_max() -> int:
    """The rollback/respawn attempt budget (``AUTODIST_RECOVER_MAX``)."""
    return max(1, int(const.ENV.AUTODIST_RECOVER_MAX.val))


def rollback(exc, ring: Optional[SnapshotRing], attempt: int,
             max_attempts: int, runner=None):
    """One recover-action rollback: return the newest good state (re-seeding
    an async runner's parameter service through ``runner.restore``), or
    ESCALATE to the existing halt when the attempt budget is spent or no
    good snapshot exists.

    ``exc`` is the signal that interrupted the run (``HealthRecover`` or
    ``AlertRecover``); escalation re-raises it as the exact halt type the
    halt action would have produced, live state attached — recover degrades
    to halt, never to silence."""
    from autodist_tpu_torch.telemetry import health as _health
    from autodist_tpu_torch.telemetry import recorder as _recorder
    if ring is not None and attempt > 1:
        # Same-incident retry: the newest snapshot was already resumed from
        # and the anomaly re-fired — a slow-burn corruption may predate it,
        # so fall back one boundary deeper instead of replaying it forever.
        ring.drop_newest()
    good = ring.checkout() if ring is not None else None
    from_step = getattr(exc, "step", None)
    if good is None or attempt > max_attempts:
        reason = ("no healthy snapshot in the ring" if good is None else
                  f"attempt {attempt} exceeds AUTODIST_RECOVER_MAX="
                  f"{max_attempts}")
        logging.error("recover: cannot roll back (%s) — escalating to halt",
                      reason)
        if isinstance(exc, _health.HealthRecover):
            raise _health.HealthHalt(exc.step, exc.state,
                                     exc.anomalies) from exc
        raise exc
    to_step, state = good
    log_rollback(from_step, to_step, attempt)
    logging.warning(
        "recover: rolling back from step %s to last-known-good step %d "
        "(attempt %d/%d) and resuming", from_step, to_step, attempt,
        max_attempts)
    # Snapshot the evidence (the bad state is still live on `exc`) through
    # the debounce — an anomaly storm mid-recovery costs one dir per window.
    _recorder.maybe_record(f"recover.rollback.s{to_step}")
    # Async-PS regimes: the parameter service owns the state — re-seed it
    # explicitly (the sync runner adopts the returned state on its next run).
    restore = getattr(runner, "restore", None)
    if callable(restore) and getattr(runner, "service", None) is not None:
        restore(state)
    return state
