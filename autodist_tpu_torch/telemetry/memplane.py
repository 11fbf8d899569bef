"""HBM memory plane: owner-attributed census, budget, pressure, OOM forensics.

The raw gauges existed before this module — ``device.mem.bytes_in_use.d<id>``
and ``device.live_bytes`` from the caching allocator's stats — but
nothing said WHOSE bytes those were, whether a candidate plan would fit
before a compile probe was spent on it, or what was resident when an OOM
killed the run. This module closes those three gaps with one registry:

- **Tag registry** — :func:`tag` claims device bytes for a named owner
  (``params`` / ``opt_state`` / ``kv_pages`` / ``prefetch`` / ``snapshots``).
  A tree claim holds WEAK references to its tensors, each storage counted
  once, so a freed tree's claim evaporates with it (no owner ever pins
  memory just by being observed); an integer claim is static until
  re-tagged.
  :func:`attribute` turns the claims plus the live-bytes gauge into
  ``mem.owned.*`` values, with ``other`` = live minus claimed, clamped at
  zero — the leak-hunting residual.
- **Budget** — :func:`device_budget` resolves the per-device usable budget
  from the first source that answers: the card's total memory
  (``torch.cuda.mem_get_info()`` x 0.8; PyTorch's allocator has no
  ``bytes_limit``), the ``AUTODIST_MEM_BUDGET`` override, else the
  8 GiB default (with a one-time warning — a silently defaulted budget is
  how the async-PS memory rule ran blind on CPU). The winning source is
  booked as ``mem.budget_source`` (0 default / 1 env / 2 measured).
- **Pressure** — :func:`current_pressure` is the worst device's
  ``bytes_in_use / bytes_limit`` (the ratio the shipped ``mem_pressure``
  alert rule thresholds); on backends with no allocator stats it degrades
  to ``live_bytes / budget`` so an injected squeeze (a tiny
  ``AUTODIST_MEM_BUDGET``) still drives the same plane. Serving admission
  reads it through :func:`kv_admission_holdback`: past the threshold the
  paged-KV allocator holds back a fraction of its reservable pages, so the
  fleet sheds load before the allocator dies.
- **OOM forensics** — :func:`is_oom_error` recognizes
  ``torch.cuda.OutOfMemoryError`` at the runner's dispatch sites; :func:`record_oom` books the ``mem.oom``
  counter + event and triggers the flight recorder (debounced), whose
  manifest carries :func:`memory_section`: the census, the per-program
  memory ledger, the last-K ``device.mem`` history samples, and the
  predicted-vs-live peak delta.

Everything degrades to a no-op shell: :func:`memory_snapshot` returns the
same keys armed or not (the ``status`` wire contract), and every sampling
failure is swallowed at debug — diagnostics must never break the run.
"""

import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.telemetry import spans as _spans
from autodist_tpu_torch.utils import logging

__all__ = ["OWNERS", "tag", "untag", "census", "attribute", "device_budget",
           "pressure_threshold", "current_pressure", "kv_admission_holdback",
           "is_oom_error", "record_oom", "memory_snapshot", "memory_section",
           "reset"]

# The attribution vocabulary: every claim lands in one of these buckets, and
# the census books exactly these plus the ``other`` residual (a stable gauge
# family — scrapers see the same series whether an owner is present or not).
OWNERS = ("params", "opt_state", "kv_pages", "prefetch", "snapshots")

DEFAULT_BUDGET_BYTES = 8 << 30     # the historical auto-strategy fallback
BUDGET_FRACTION = 0.8              # usable share of the measured limit
KV_HOLDBACK_FRACTION = 0.25        # reservable pages withheld under pressure
_PRESSURE_CACHE_S = 1.0            # admission-path refresh throttle
_SOURCE_CODE = {"default": 0.0, "env": 1.0, "measured": 2.0}

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "Out of memory",
                "out of memory", "Allocation failure", "allocating")


def _tensors(tree):
    """The tensors of a tree: a tensor, a dict, list or tuple, a
    ``torch.optim.Optimizer`` (its per-parameter state), a staged batch
    block or micro-batched leaf, or a dataclass such as ``TrainState`` (its
    fields)."""
    import dataclasses
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.optim.Optimizer):
        yield from _tensors(list(tree.state.values()))
    elif hasattr(tree, "tree"):                # a staged BatchBlock
        yield from _tensors(tree.tree)
    elif isinstance(getattr(tree, "value", None), torch.Tensor):   # MicroBatched
        yield tree.value
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if f.name != "layout":
                yield from _tensors(getattr(tree, f.name))


class _Claim:
    """One owner's claim: either a static byte count or weakrefs to the
    tensors of a tagged tree (freed tensors drop out)."""

    __slots__ = ("nbytes", "refs")

    def __init__(self, nbytes: Optional[int] = None,
                 refs: Optional[List[Tuple[Any, int]]] = None):
        self.nbytes = nbytes
        self.refs = refs

    def live(self) -> Tuple[int, bool]:
        """(live bytes, any leaf still alive). Static claims are always
        alive; a tree claim whose every leaf died reports dead so the
        registry can prune it."""
        if self.refs is None:
            return int(self.nbytes or 0), True
        total, alive = 0, False
        for ref, nb in self.refs:
            leaf = ref()
            if leaf is None:
                continue
            alive = True
            total += nb
        return total, alive


_LOCK = threading.Lock()
_CLAIMS: Dict[str, Dict[str, _Claim]] = {}
_WARNED_DEFAULT = [False]
_PRESSURE = {"value": 0.0, "t": 0.0, "set": False}


def tag(owner: str, tree_or_nbytes: Any, key: str = "default") -> None:
    """Claim ``owner``'s device bytes for the census. An int/float claims a
    static byte count; anything else is treated as a tree (:func:`_tensors`)
    whose tensors are weakly referenced, each storage counted once at its
    full size (the claim follows the tensors' lifetime — re-tagging at each
    boundary replaces the claim, a freed tree's claim evaporates on its
    own). ``key`` scopes concurrent claimants of one owner (two paged
    engines in one process)."""
    if isinstance(tree_or_nbytes, (int, float)) \
            and not isinstance(tree_or_nbytes, bool):
        claim = _Claim(nbytes=int(tree_or_nbytes))
    else:
        try:
            refs: List[Tuple[Any, int]] = []
            seen = set()
            for leaf in _tensors(tree_or_nbytes):
                if leaf.device.type == "meta":
                    continue
                storage = leaf.untyped_storage()
                key_ = (leaf.device.type, leaf.device.index, storage.data_ptr())
                nb = int(storage.nbytes())
                if nb <= 0 or key_ in seen:
                    continue
                seen.add(key_)
                try:
                    refs.append((weakref.ref(leaf), nb))
                except TypeError:      # exotic leaf: skip, never pin
                    continue
            claim = _Claim(refs=refs)
        except Exception as e:  # noqa: BLE001 — a census tag must never fail
            logging.debug("memplane.tag(%s) skipped: %s", owner, e)
            return
    with _LOCK:
        entries = _CLAIMS.setdefault(str(owner), {})
        entries[str(key)] = claim
        # Opportunistic prune so churny taggers (prefetch) stay bounded.
        for k in [k for k, c in entries.items() if not c.live()[1]]:
            del entries[k]


def untag(owner: str, key: str = "default") -> None:
    """Drop one claim (idempotent)."""
    with _LOCK:
        entries = _CLAIMS.get(str(owner))
        if entries:
            entries.pop(str(key), None)


def reset() -> None:
    """Drop every claim and the pressure cache (tests)."""
    with _LOCK:
        _CLAIMS.clear()
    _PRESSURE.update(value=0.0, t=0.0, set=False)
    _WARNED_DEFAULT[0] = False


def census() -> Dict[str, int]:
    """Live claimed bytes per owner (dead tree claims pruned as a side
    effect). Owners with no claim are absent — :func:`attribute` restores
    the full stable vocabulary."""
    out: Dict[str, int] = {}
    with _LOCK:
        for owner, entries in list(_CLAIMS.items()):
            total = 0
            for key in list(entries):
                nbytes, alive = entries[key].live()
                if not alive:
                    del entries[key]
                    continue
                total += nbytes
            if entries:
                out[owner] = total
            else:
                del _CLAIMS[owner]
    return out


def attribute(live_bytes: int) -> Dict[str, int]:
    """The owner-attributed view of ``live_bytes``: every :data:`OWNERS`
    bucket (0 when unclaimed) plus ``other`` — live minus claimed, CLAMPED
    at zero (claims can overshoot the live gauge when an owner tags bytes
    the live census does not see; the residual is a leak detector, and a
    negative leak is a lie)."""
    counts = census()
    out = {owner: int(counts.get(owner, 0)) for owner in OWNERS}
    claimed = sum(out.values())
    out["other"] = max(0, int(live_bytes) - claimed)
    return out


# ------------------------------------------------------------------ budget

def device_budget() -> Tuple[int, str]:
    """Per-device usable memory budget and its source: ``measured``
    (the smallest local card's total memory from
    ``torch.cuda.mem_get_info()``, x 0.8), ``env``
    (``AUTODIST_MEM_BUDGET`` bytes), or ``default`` (8 GiB, warned once —
    a budget nobody chose should not be a budget nobody sees). Books
    ``mem.budget_bytes`` / ``mem.budget_source``."""
    budget, source = 0, ""
    try:
        import torch
        if torch.cuda.is_available():
            limit = min((int(torch.cuda.mem_get_info(i)[1])
                         for i in range(torch.cuda.device_count())), default=0)
            if limit > 0:
                budget, source = int(limit * BUDGET_FRACTION), "measured"
    except Exception as e:  # noqa: BLE001 — an unreadable card reports nothing
        logging.debug("memory budget probe unavailable: %s", e)
    if not budget:
        try:
            env = int(const.ENV.AUTODIST_MEM_BUDGET.val)
        except (TypeError, ValueError):
            env = 0
        if env > 0:
            budget, source = env, "env"
    if not budget:
        budget, source = DEFAULT_BUDGET_BYTES, "default"
        if not _WARNED_DEFAULT[0]:
            _WARNED_DEFAULT[0] = True
            logging.warning(
                "memory plane: no allocator limit and no AUTODIST_MEM_BUDGET "
                "— memory rules (async-PS optimizer choice, autotune "
                "pre-flight) run on the %d GiB default",
                DEFAULT_BUDGET_BYTES >> 30)
    try:
        _metrics.gauge("mem.budget_bytes").set(budget)
        _metrics.gauge("mem.budget_source").set(_SOURCE_CODE[source])
    except Exception:  # noqa: BLE001 — booking is best-effort
        pass
    return budget, source


def pressure_threshold() -> float:
    """The ``AUTODIST_MEM_PRESSURE`` ratio past which the plane reacts
    (the shipped alert rule's value and the KV holdback trigger)."""
    try:
        value = float(const.ENV.AUTODIST_MEM_PRESSURE.val)
    except (TypeError, ValueError):
        return 0.92
    return value if value > 0 else 0.92


def _card_stats() -> Dict[int, Tuple[int, int]]:
    """``{card: (allocated bytes, total bytes)}`` for every local card, from
    the caching allocator and ``torch.cuda.mem_get_info``; empty without a
    card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return {i: (int(torch.cuda.memory_allocated(i)), int(torch.cuda.mem_get_info(i)[1]))
            for i in range(torch.cuda.device_count())}


def _measure_pressure() -> float:
    """Worst card's allocated bytes over its total memory; with no card,
    the claimed bytes over the budget (so an injected squeeze, a tiny
    ``AUTODIST_MEM_BUDGET``, drives the same plane on the host)."""
    worst = None
    for used, total in _card_stats().values():
        if total > 0:
            ratio = used / total
            worst = ratio if worst is None else max(worst, ratio)
    if worst is None:
        live = sum(census().values())
        budget, _ = device_budget()
        worst = live / budget if budget > 0 else 0.0
    return float(worst)


def current_pressure(max_age_s: float = _PRESSURE_CACHE_S) -> float:
    """The pressure ratio, cached for ``max_age_s`` (the serving admission
    path reads it per request — one allocator probe per second, not per
    admission). Books ``mem.pressure`` on refresh; failures return the
    last value (diagnostics never gate admission on a backend hiccup)."""
    now = time.monotonic()
    if _PRESSURE["set"] and now - _PRESSURE["t"] < max_age_s:
        return _PRESSURE["value"]
    try:
        value = _measure_pressure()
        _metrics.gauge("mem.pressure").set(round(value, 6))
    except Exception as e:  # noqa: BLE001
        logging.debug("memory pressure sampling unavailable: %s", e)
        return _PRESSURE["value"]
    _PRESSURE.update(value=value, t=now, set=True)
    return value


def kv_admission_holdback(usable_pages: int) -> int:
    """Pages the paged-KV allocator should withhold from NEW reservations:
    0 below the pressure threshold, ``KV_HOLDBACK_FRACTION`` of the usable
    pool at/above it (in-flight requests keep their reservations — the
    engine sheds admissions, the allocator never dies mid-decode)."""
    if usable_pages <= 0:
        return 0
    if current_pressure() < pressure_threshold():
        return 0
    return max(1, int(usable_pages * KV_HOLDBACK_FRACTION))


# ------------------------------------------------------------------ OOM

def is_oom_error(exc: BaseException) -> bool:
    """Does this look like a device allocator exhaustion? PyTorch raises
    ``torch.cuda.OutOfMemoryError`` (a ``RuntimeError`` whose message says
    "out of memory"); NCCL and the kernels' wrappers may surface it as a
    plain ``RuntimeError`` with the same words."""
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    if any(marker in msg for marker in _OOM_MARKERS):
        return "RESOURCE" in msg.upper() or "memory" in msg.lower()
    return False


def record_oom(where: str, exc: BaseException) -> None:
    """Book the OOM (``mem.oom`` counter + structured event), refresh the
    pressure gauge, and trigger the flight recorder THROUGH its debounce —
    the manifest's ``memory`` section is the autopsy. Never raises: the
    caller re-raises the real error and forensics must not mask it."""
    try:
        _metrics.counter("mem.oom").inc()
        _metrics.event("mem.oom", where=str(where), error=str(exc)[:300])
        current_pressure(max_age_s=0.0)
        from autodist_tpu_torch.telemetry import recorder as _recorder
        _recorder.maybe_record(f"oom.{where}")
    except Exception as e:  # noqa: BLE001 — forensics never mask the OOM
        logging.debug("OOM forensics capture failed: %s", e)


# ------------------------------------------------------------- snapshots

def _armed() -> bool:
    """The plane is armed when telemetry records or anyone tagged bytes."""
    with _LOCK:
        has_claims = bool(_CLAIMS)
    return has_claims or _spans.enabled()


def memory_snapshot() -> Dict[str, Any]:
    """The ``status`` wire section: a STABLE shell (same keys armed or
    not), filled with the census / pressure / budget / per-device stats
    when the plane is armed. Cheap enough for a 2 s console poll."""
    shell: Dict[str, Any] = {"owned": {}, "live_bytes": 0, "pressure": 0.0,
                             "budget_bytes": 0, "budget_source": "",
                             "devices": {}}
    if not _armed():
        return shell
    try:
        cards = _card_stats()
        live = sum(used for used, _ in cards.values())
        shell["live_bytes"] = live
        shell["owned"] = attribute(live)
        budget, source = device_budget()
        shell["budget_bytes"], shell["budget_source"] = budget, source
        shell["pressure"] = round(current_pressure(), 6)
        for i, (used, total) in cards.items():
            shell["devices"][f"d{i}"] = {"bytes_in_use": used, "bytes_limit": total}
    except Exception as e:  # noqa: BLE001 — a status poll must not 500
        logging.debug("memory snapshot unavailable: %s", e)
    return shell


def memory_section(history_k: int = 8) -> Dict[str, Any]:
    """The flight-recorder manifest section: :func:`memory_snapshot` plus
    the per-program memory ledger, the last-``history_k`` ``device.mem`` /
    ``mem.*`` history samples, and the predicted-vs-live peak delta
    (resident claimed bytes + the ledger's worst program temp, against the
    worst live ``bytes_in_use`` — the number an OOM autopsy opens with)."""
    section = memory_snapshot()
    try:
        from autodist_tpu_torch.telemetry import profiling as _profiling
        programs: Dict[str, Dict[str, Any]] = {}
        for sig, rec in _profiling.program_costs().items():
            programs[sig] = {
                "kind": rec.kind,
                "argument_bytes": rec.argument_bytes,
                "output_bytes": rec.output_bytes,
                "temp_bytes": rec.temp_bytes,
                "generated_code_bytes": rec.generated_code_bytes,
            }
        section["programs"] = programs
    except Exception:  # noqa: BLE001 — ledger is optional in the autopsy
        section["programs"] = {}
    try:
        from autodist_tpu_torch.telemetry import history as _history
        hist = _history.get_history()
        tail: List[Dict[str, Any]] = []
        if hist is not None:
            for sample in hist.samples()[-max(1, history_k):]:
                row = {k: v for k, v in sample.items()
                       if k == "t_wall_s" or k == "step"
                       or k.startswith("device.mem.")
                       or k.startswith("device.live_")
                       or k.startswith("mem.")}
                tail.append(row)
        section["history"] = tail
    except Exception:  # noqa: BLE001
        section["history"] = []
    try:
        temps = [p.get("temp_bytes") or 0
                 for p in section.get("programs", {}).values()]
        resident = sum(section["owned"].get(o, 0) for o in OWNERS)
        predicted = resident + (max(temps) if temps else 0)
        live_peak = max(
            [d["bytes_in_use"] for d in section["devices"].values()]
            or [section["live_bytes"]])
        section["predicted_peak_bytes"] = int(predicted)
        section["live_peak_bytes"] = int(live_peak)
        section["peak_delta_bytes"] = int(live_peak - predicted)
    except Exception:  # noqa: BLE001
        pass
    return section
