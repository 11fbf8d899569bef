"""Deterministic fault injection for the self-healing runtime (the port's
copy of ``autodist_tpu/testing/faults.py``; the same spec grammar, kinds and
consumption rules).

The recovery plane's tests and ``chip_smoke.py``'s phase 18 drive real
failures through the real code paths: a mocked "eviction" proves nothing
about the staleness gate. This module is the shared fault harness: a small set of
fault POINTS, each keyed deterministically (exact step index, worker id,
firing count), installed either programmatically (:func:`install`) or via the
``AUTODIST_FAULTS`` env flag, and consulted by a handful of instrumented
sites in the product code:

=================  ==========================================  =============
kind               instrumented site                           effect
=================  ==========================================  =============
``worker_crash``   ``RemotePSWorker.step`` /                   sockets closed
                   ``AsyncWorker.step``                        abruptly, then
                                                               :class:`WorkerCrashed`
``worker_hang``    same sites                                  bounded
                                                               ``time.sleep(for_s)``
``nan_grads``      ``train()``'s per-step loop                 batch floats
                                                               NaN-filled (real
                                                               NaN gradients
                                                               through the real
                                                               step)
``wire_refuse``    ``_PSClient`` connect attempts              ``ConnectionRefusedError``
``wire_reset``     ``_PSClient.call_raw`` (keyed by ``op``)    socket closed +
                                                               ``ConnectionResetError``
                                                               before the send
``wire_slow``      ``ps_transport._send_payload``              payload sends
                                                               throttled to
                                                               ``bytes_per_s``
                                                               (sleep before
                                                               send)
=================  ==========================================  =============

Spec grammar (``AUTODIST_FAULTS`` or :func:`install`): semicolon-separated
points, each ``kind@key=value,key=value``::

    worker_crash@step=3,worker=1;nan_grads@step=5;wire_refuse@count=2
    worker_hang@step=2,worker=0,for_s=0.5;wire_reset@op=read

``count`` bounds how many times a point fires (default 1 — a fault that
fired is consumed, so a recover-and-replay pass sails through the step that
failed the first time; set ``count`` high to model a persistent fault).
Matching and consumption happen under one lock, so concurrent workers see
each firing exactly once — the determinism the chaos tests pin.

Un-armed cost: :func:`armed` is one module-global read (plus, once per
process, one env read to adopt ``AUTODIST_FAULTS``). The product sites gate
every other call on it.
"""

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Union

from autodist_tpu_torch import const

_log = logging.getLogger("autodist_tpu_torch")

__all__ = ["FaultPoint", "WorkerCrashed", "KINDS", "parse", "install",
           "clear", "armed", "should_fire", "hang_s", "corrupt_batch",
           "points", "throttle_s"]

KINDS = ("worker_crash", "worker_hang", "nan_grads", "wire_refuse",
         "wire_reset", "wire_slow")


class WorkerCrashed(RuntimeError):
    """Raised at a ``worker_crash`` fault point after the worker's transport
    sockets were torn down — the in-process stand-in for a killed worker
    process (the server observes exactly what a real crash produces: an
    abrupt EOF). Supervising harnesses catch it and respawn."""


@dataclasses.dataclass
class FaultPoint:
    """One deterministic fault: ``kind`` plus its match keys. ``None`` keys
    match anything; ``fired`` counts consumptions against ``count``."""

    kind: str
    step: Optional[int] = None      # exact step index (site-defined counter)
    worker: Optional[int] = None    # exact worker id
    op: Optional[str] = None        # wire opcode (wire_reset)
    count: int = 1                  # firings before the point is spent
    for_s: float = 0.0              # hang duration (worker_hang)
    bytes_per_s: float = 0.0        # injected wire bandwidth (wire_slow)
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; valid: "
                             f"{', '.join(KINDS)}")
        if self.count < 1:
            raise ValueError("fault count must be >= 1")

    def matches(self, step, worker, op) -> bool:
        if self.fired >= self.count:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.worker is not None and worker != self.worker:
            return False
        if self.op is not None and op != self.op:
            return False
        return True


_INT_KEYS = ("step", "worker", "count")
_FLOAT_KEYS = ("for_s", "bytes_per_s")


def parse(spec: str) -> List[FaultPoint]:
    """Parse the spec grammar into fault points; raises ``ValueError`` on a
    malformed spec (fault injection is an explicit test/ops act — a typo
    must fail loudly, unlike the alert rules' degrade-and-warn contract)."""
    out: List[FaultPoint] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, args = part.partition("@")
        kwargs: Dict[str, Any] = {}
        for pair in filter(None, (p.strip() for p in args.split(","))):
            key, sep, value = pair.partition("=")
            if not sep:
                raise ValueError(f"fault spec {part!r}: expected key=value, "
                                 f"got {pair!r}")
            key = key.strip()
            if key in _INT_KEYS:
                kwargs[key] = int(value)
            elif key in _FLOAT_KEYS:
                kwargs[key] = float(value)
            elif key == "op":
                kwargs[key] = value.strip()
            else:
                raise ValueError(f"fault spec {part!r}: unknown key {key!r}")
        out.append(FaultPoint(kind=kind.strip(), **kwargs))
    return out


_LOCK = threading.Lock()
_PLAN: Optional[List[FaultPoint]] = None
_ENV_CHECKED = False


def install(spec: Union[str, List[FaultPoint]]) -> List[FaultPoint]:
    """Arm the harness with a spec string or a pre-built point list; returns
    the live points (their ``fired`` counters update in place)."""
    global _PLAN, _ENV_CHECKED
    plan = parse(spec) if isinstance(spec, str) else list(spec)
    with _LOCK:
        _PLAN = plan
        _ENV_CHECKED = True   # an explicit install overrides the env spec
    if plan:
        _log.warning("faults: armed with %d fault point(s): %s",
                        len(plan), "; ".join(p.kind for p in plan))
    return plan


def clear():
    """Disarm (tests' teardown). Also suppresses re-arming from the env —
    a cleared harness stays cleared for the process."""
    global _PLAN, _ENV_CHECKED
    with _LOCK:
        _PLAN = None
        _ENV_CHECKED = True


def armed() -> bool:
    """True when any fault plan is installed. First call adopts
    ``AUTODIST_FAULTS`` when set (one env read per process)."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is not None:
        return True
    if not _ENV_CHECKED:
        with _LOCK:
            if not _ENV_CHECKED:
                _ENV_CHECKED = True
                spec = const.ENV.AUTODIST_FAULTS.val
                if spec:
                    _PLAN = parse(spec)
                    _log.warning("faults: armed from AUTODIST_FAULTS "
                                    "(%d point(s))", len(_PLAN))
    return _PLAN is not None


def points() -> List[FaultPoint]:
    """The live plan (empty when disarmed) — tests assert consumption."""
    with _LOCK:
        return list(_PLAN or [])


def should_fire(kind: str, step: Optional[int] = None,
                worker: Optional[int] = None,
                op: Optional[str] = None) -> bool:
    """Match-and-consume one firing of ``kind`` against the installed plan.
    The check and the ``fired`` bump share one critical section, so N
    concurrent callers consume exactly ``count`` firings total."""
    plan = _PLAN
    if plan is None:
        return False
    with _LOCK:
        for p in plan:
            if p.kind == kind and p.matches(step, worker, op):
                p.fired += 1
                _log.warning("faults: firing %s (step=%s worker=%s op=%s, "
                                "%d/%d)", kind, step, worker, op, p.fired,
                                p.count)
                return True
    return False


def hang_s(step: Optional[int] = None,
           worker: Optional[int] = None) -> float:
    """Consume a ``worker_hang`` firing; returns its bounded duration
    (0.0 when none fires). The caller sleeps — the harness never parks a
    thread itself."""
    plan = _PLAN
    if plan is None:
        return 0.0
    with _LOCK:
        for p in plan:
            if p.kind == "worker_hang" and p.matches(step, worker, None):
                p.fired += 1
                _log.warning("faults: hanging worker %s at step %s for "
                                "%.3fs", worker, step, p.for_s)
                return max(0.0, float(p.for_s))
    return 0.0


def throttle_s(nbytes: int) -> float:
    """Seconds a ``wire_slow`` point charges a payload of ``nbytes`` (an
    injected bandwidth: a congested fabric on loopback). Unlike the
    discrete faults this does NOT consume a firing: a bandwidth is a
    standing condition, not an event (``count`` is ignored; ``clear()``
    lifts it). The caller sleeps — the harness never parks a thread."""
    plan = _PLAN
    if plan is None:
        return 0.0
    with _LOCK:
        for p in plan:
            if p.kind == "wire_slow" and p.bytes_per_s > 0:
                return nbytes / p.bytes_per_s
    return 0.0


def maybe_hang(step: Optional[int] = None, worker: Optional[int] = None):
    """Sleep out a matching ``worker_hang`` point (bounded by its spec)."""
    duration = hang_s(step=step, worker=worker)
    if duration > 0.0:
        time.sleep(duration)   # bounded by the installed spec


def corrupt_batch(batch):
    """NaN-fill every float leaf of a batch tree (dicts, lists, tuples,
    ``MicroBatched``); integer and bool leaves keep their values. Leaves come
    back as host tensors."""
    import numpy as np
    import torch

    from autodist_tpu_torch.runner import MicroBatched

    def nanify(leaf):
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor)
                            else leaf).detach().cpu()
        if not t.is_floating_point():
            return t
        return torch.full(t.shape, float("nan"), dtype=t.dtype)

    def walk(tree):
        if isinstance(tree, MicroBatched):
            return MicroBatched(nanify(tree.value))
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return nanify(tree)

    return walk(batch)
