"""Performance attribution: static program costs, phase shares, roofline gauges.

The telemetry stack records WHAT happened (spans, metrics, anomalies); this
module answers WHY A STEP IS SLOW, in three layers over the same substrate:

- **Static cost extraction** — at the runner's build-probe site (the shape-
  signature dispatch in ``runner.py``), every first-of-its-signature step
  (and every ``unroll=K`` graph) contributes the runner's ``plan_costs``
  (flops, bytes accessed, from a trace of the step on fake tensors with the
  kernel wrappers' own counts; PyTorch has no compiled program to ask, so
  this stands where the JAX package reads XLA's cost analysis) to a
  per-signature :class:`ProgramCost` cache, marked
  ``source="fake-trace"``; later dispatches of the same signature only bump
  its dispatch count. Where the trace fails, an analytic estimate installed
  via :func:`set_analytic_flops` stands in, marked ``source="analytic"``.
- **Phase attribution + roofline gauges** — :func:`observe_period` decomposes
  each train() log period's wall time into ``train.attr.{data_wait,host,comm,
  compute,readback}`` share gauges by joining the period's span durations
  (``spans._export_columns``) against the host timeline, and books
  ``train.mfu`` / ``train.membw_util`` — achieved flops/s and bytes/s over
  the :func:`peak_spec` hardware peaks — from the period's dispatched program
  costs. ``compute`` is the residual: wall time the host spent neither
  producing data, dispatching, on the wire, nor syncing — i.e. parked behind
  the device. Shares always sum to 1.0 (test-pinned). On a CUDA card the
  residual misleads (the port's divergence): a step of thousands of
  launches fills the launch queue, and the enqueue inside
  ``train.dispatch`` then waits for the card, which would count as host.
  There the runner brackets each dispatch with two CUDA events
  (:func:`device_timed`; no kernel), ``compute`` is the card's time
  between them, summed over the period, and the host phases' spans share
  the rest of the period (:func:`_device_parts`).
- **Profile store** — :func:`write_profile` emits one schema-versioned JSON
  per run (program costs, per-period attribution + MFU series, weighted
  summary, env manifest via the flight recorder's manifest helper);
  ``tools/adprof.py`` summarizes and DIFFS two profiles, naming the regressed
  phase, and :mod:`autodist_tpu_torch.telemetry.costmodel` calibrates a step-time
  predictor from one — the interface the strategy search calls.

Cost contract: everything here keys off :func:`active` — profiling rides the
span plane, so :func:`enable` also enables spans. With profiling off and
telemetry on, dispatch counting is one dict increment per dispatch; with
both off, the hot paths pay nothing new (``bench.py --attr-overhead`` gates
the enabled side at <=2% of a host-bound step).
"""

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.telemetry import spans as _spans
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["PeakSpec", "peak_spec", "ProgramCost", "enable", "disable",
           "active", "reset", "note_dispatch", "record_program_cost",
           "program_costs", "device_timed", "set_analytic_flops",
           "set_applied_plan",
           "applied_plan", "observe_period",
           "format_attr_line", "format_shares", "attribution_periods",
           "profile_document",
           "write_profile", "maybe_write_profile", "PROFILE_SCHEMA",
           "PROFILE_SCHEMA_VERSION", "ATTR_PHASES"]

# Profile JSON identity, pinned by tests and read back by tools/adprof.py and
# telemetry/costmodel.py. Bump the version on any breaking key change.
PROFILE_SCHEMA = "autodist-profile"
PROFILE_SCHEMA_VERSION = 1

# The attribution phases, in the order log lines and adprof render them.
ATTR_PHASES = ("compute", "comm", "host", "data_wait", "readback")

# Dense bf16 peak FLOP/s per card, keyed by ``torch.cuda.get_device_name()``
# prefix (longest first): NVIDIA's H100 Tensor Core GPU data sheet, dense
# rates without sparsity, at the card's full power limit (700 W for the SXM
# part). ``utils/flops.py`` reads the same table through :func:`peak_spec`.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # SXM5
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H100 PCIe": 756e12,
}

# HBM bandwidth per card, bytes/s, from the same data sheet and keying.
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM5
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


@dataclass(frozen=True)
class PeakSpec:
    """Per-device hardware peaks the roofline gauges divide by. ``None``
    means unknown (e.g. CPU without an override) — dependent gauges are
    simply not booked then, never guessed."""

    flops_per_s: Optional[float]
    membw_bytes_per_s: Optional[float]
    source: str   # "env" | "device:<kind>" | "unknown"

    def to_dict(self) -> Dict[str, Any]:
        return {"flops_per_s": self.flops_per_s,
                "membw_bytes_per_s": self.membw_bytes_per_s,
                "source": self.source}


_WARNED_PEAKS = set()


def _parse_peak(raw: str, flag: str) -> Optional[float]:
    """A peak override as float, or None when unset OR malformed — peaks
    must never break a run (observe_period calls this at every training log
    boundary), so a typo'd ``AUTODIST_PEAK_FLOPS=197T`` warns once and
    degrades to unknown instead of raising."""
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        if flag not in _WARNED_PEAKS:
            _WARNED_PEAKS.add(flag)
            logging.warning("%s=%r is not a number; ignoring the override "
                            "(use plain floats like 197e12)", flag, raw)
        return None


def peak_spec(device=None) -> PeakSpec:
    """The shared peak-spec helper: per-device peak FLOP/s and HBM bytes/s.

    ``AUTODIST_PEAK_FLOPS`` / ``AUTODIST_PEAK_MEMBW`` override either side
    (new hardware, calibrated peaks); otherwise both come from the card
    name's data-sheet tables (``device``: a torch device, default the
    current card). The CPU (and cards not in the tables) yield ``None``
    sides — MFU against a meaningless peak would be noise. The tables hold
    H100 rows only."""
    flops_env = str(const.ENV.AUTODIST_PEAK_FLOPS.val)
    membw_env = str(const.ENV.AUTODIST_PEAK_MEMBW.val)
    flops = _parse_peak(flops_env, "AUTODIST_PEAK_FLOPS")
    membw = _parse_peak(membw_env, "AUTODIST_PEAK_MEMBW")
    if flops is None:
        flops_env = ""   # a rejected override falls through to the tables
    if membw is None:
        membw_env = ""
    if flops is not None and membw is not None:
        return PeakSpec(flops, membw, "env")
    kind = ""
    if flops is None or membw is None:
        try:
            import torch
            if device is None and torch.cuda.is_available():
                device = torch.device("cuda", torch.cuda.current_device())
            if device is not None and torch.device(device).type == "cuda":
                kind = torch.cuda.get_device_name(torch.device(device))
        except Exception:  # noqa: BLE001 — peaks must never break a run
            kind = ""
    for prefix, peak in PEAK_BF16_FLOPS.items():
        if kind.startswith(prefix):
            flops = peak if flops is None else flops
            break
    for prefix, peak in PEAK_HBM_BYTES.items():
        if kind.startswith(prefix):
            membw = peak if membw is None else membw
            break
    if flops_env or membw_env:
        source = "env"
    elif kind:
        source = f"device:{kind}"
    else:
        source = "unknown"
    return PeakSpec(flops, membw, source)


@dataclass
class ProgramCost:
    """One compiled program's static cost record, keyed by the runner's
    shape-signature digest (the crc32 the ``jit.compile`` span carries).
    ``flops``/``bytes_accessed`` are PER DISPATCH of the program — a fused
    ``steps=K`` block program already contains its K scanned steps, so
    per-step numbers divide by ``steps``."""

    sig: str
    kind: str                       # "step" | "many" | caller-defined
    steps: int = 1                  # train steps one dispatch advances
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    output_bytes: Optional[float] = None
    compile_s: Optional[float] = None
    dispatches: int = 0
    source: Optional[str] = None    # "fake-trace" | "analytic" | None
    # The memory ledger (the JAX package's XLA memory_analysis(); the
    # port's fake-tensor trace leaves it None) — the
    # bytes a dispatch pins while it runs (arguments + outputs + temps +
    # code), UNscaled by steps (unlike flops, a K-step block's working set
    # does not multiply). ``temp_bytes`` is the term the cost model adds to
    # resident state for its peak-HBM estimate.
    argument_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "steps": self.steps, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "output_bytes": self.output_bytes,
                "compile_s": self.compile_s, "dispatches": self.dispatches,
                "source": self.source,
                "argument_bytes": self.argument_bytes,
                "temp_bytes": self.temp_bytes,
                "generated_code_bytes": self.generated_code_bytes}


class _State:
    """Process-global profiling state; one lock covers the cost cache and the
    period bookkeeping (boundary-rate access only — never per dispatch
    beyond one dict increment)."""

    def __init__(self):
        self.enabled = False
        self.lock = san_lock()
        self.costs: Dict[str, ProgramCost] = {}
        self.analytic_flops_per_step: Optional[float] = None
        self.periods: List[Dict[str, Any]] = []
        self.period_start_ns: Optional[int] = None
        self.last_dispatches: Dict[str, int] = {}
        # CUDA event pairs around the period's dispatches (device_timed),
        # and the seconds of pairs folded in early to bound the list.
        self.device_windows: List[tuple] = []
        self.device_s = 0.0
        # The execution plan this process applied (the autotuner's record:
        # cache key + knobs + predicted vs measured) — attached to profile
        # JSONs and flight-recorder manifests so a snapshot or adprof diff
        # names which plan a run was executing. Survives reset(): it
        # describes the session, not an attribution period.
        self.applied_plan: Optional[Dict[str, Any]] = None


_STATE = _State()
_MAX_PERIODS = 4096   # ~4k log boundaries per run retained in a profile


def enable():
    """Turn the attribution plane on. Profiling joins span durations, so this
    also enables span recording (the reverse is not true: telemetry alone
    never pays for cost extraction)."""
    _STATE.enabled = True
    _spans.enable()
    with _STATE.lock:
        if _STATE.period_start_ns is None:
            _STATE.period_start_ns = time.perf_counter_ns()
            # Baseline the dispatch counters at the window open: telemetry-
            # only runs count dispatches too (note_dispatch), and a mid-run
            # enable() must not charge the whole prior run's dispatches to
            # its first period.
            _STATE.last_dispatches = {sig: rec.dispatches
                                      for sig, rec in _STATE.costs.items()}


def disable():
    _STATE.enabled = False
    with _STATE.lock:
        # Close the attribution clock: without this, the first
        # observe_period after a re-enable would charge the whole disabled
        # stretch (no spans recorded there, so it lands in "compute") to
        # its period — exactly what the interleaved attr-overhead bench
        # rounds would hit.
        _STATE.period_start_ns = None
        _STATE.device_windows.clear()
        _STATE.device_s = 0.0


def active() -> bool:
    return _STATE.enabled


def reset():
    """Drop every cost record and attribution period (tests; production
    profiling state lives for the process)."""
    with _STATE.lock:
        _STATE.costs.clear()
        _STATE.periods.clear()
        _STATE.last_dispatches.clear()
        _STATE.analytic_flops_per_step = None
        _STATE.device_windows.clear()
        _STATE.device_s = 0.0
        _STATE.period_start_ns = (time.perf_counter_ns()
                                  if _STATE.enabled else None)


def set_applied_plan(plan: Optional[Dict[str, Any]]):
    """Record the execution plan this process is running (the autotuner's
    ``TunedPlan.to_dict()`` + name). Rides every subsequently-written
    profile document (``"plan"`` key) and flight-recorder manifest, so
    diagnostics name the plan a run was executing. ``None`` clears."""
    with _STATE.lock:
        _STATE.applied_plan = dict(plan) if plan else None


def applied_plan() -> Optional[Dict[str, Any]]:
    with _STATE.lock:
        return dict(_STATE.applied_plan) if _STATE.applied_plan else None


def set_analytic_flops(flops_per_step: Optional[float]):
    """Install the analytic per-step FLOPs fallback (``utils/flops.py``'s
    counts) used when a step's cost trace reports nothing."""
    with _STATE.lock:
        _STATE.analytic_flops_per_step = flops_per_step


def note_dispatch(sig: str, kind: str, steps: int = 1):
    """Count one dispatch of signature ``sig`` (get-or-create its record).
    Called by the runner for EVERY compiled-program dispatch while telemetry
    is enabled — one dict increment, so it is cheap enough to ride the
    existing signature computation."""
    with _STATE.lock:
        rec = _STATE.costs.get(sig)
        if rec is None:
            rec = _STATE.costs[sig] = ProgramCost(sig=sig, kind=kind,
                                                  steps=int(steps))
        rec.dispatches += 1


_MAX_DEVICE_WINDOWS = 4096   # pairs held between boundaries before folding


class _DeviceWindow:
    """A dispatch span with a CUDA event recorded on the current stream as
    it opens and as it closes; the pair is booked for the period."""

    __slots__ = ("_inner", "_start")

    def __init__(self, inner):
        self._inner = inner
        self._start = None

    def __enter__(self):
        self._inner.__enter__()
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        oldest = None
        with _STATE.lock:
            windows = _STATE.device_windows
            windows.append((self._start, end))
            if len(windows) > _MAX_DEVICE_WINDOWS:
                oldest = windows.pop(0)
        if oldest is not None:
            # Waited for outside the lock: no other thread's booking stalls
            # behind the card.
            start, stop = oldest
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
            with _STATE.lock:
                _STATE.device_s += seconds
        return self._inner.__exit__(*exc)


def device_timed(span, device):
    """``span`` (a dispatch's), its device time booked for the period's
    ``compute`` when profiling is on and ``device`` is a CUDA device; else
    ``span`` itself."""
    if not _STATE.enabled or getattr(device, "type", None) != "cuda":
        return span
    return _DeviceWindow(span)


def _drain_device_seconds() -> Optional[float]:
    """The device seconds of the period's dispatch windows (None: none was
    booked, as on the host); waits for the last one to end on the card."""
    with _STATE.lock:
        windows, _STATE.device_windows = _STATE.device_windows, []
        folded, _STATE.device_s = _STATE.device_s, 0.0
    if not windows:
        return folded or None
    windows[-1][1].synchronize()
    return folded + sum(start.elapsed_time(end) for start, end in windows) / 1e3


def _device_parts(measured: Dict[str, float], period_s: float,
                  device_s: float) -> Dict[str, float]:
    """The period's phases in seconds when the card's own time is known:
    ``compute`` is the device time of its dispatches (at most the period);
    the host phases' spans share the rest in proportion (their time under
    the card's is not exposed), and what they leave of it is
    uninstrumented host time."""
    compute = min(device_s, period_s)
    rest = period_s - compute
    spent = sum(measured.values())
    if spent > rest:
        parts = {k: v * rest / spent for k, v in measured.items()}
    else:
        parts = dict(measured)
        parts["host"] += rest - spent
    parts["compute"] = compute
    return parts


def record_program_cost(sig: str, kind: str, steps: int,
                        cost: Optional[Dict[str, float]],
                        compile_s: Optional[float] = None) -> ProgramCost:
    """Attach a compiled program's static costs to its signature record
    (creating it if the dispatch count never touched it). ``cost`` is the
    runner-extracted ``{"flops", "bytes_accessed", "output_bytes"}`` dict
    (plus the ``argument_bytes``/``temp_bytes``/``generated_code_bytes``
    memory ledger), or None when the backend reported nothing — the analytic
    fallback (scaled by ``steps``) stands in then."""
    with _STATE.lock:
        rec = _STATE.costs.get(sig)
        if rec is None:
            rec = _STATE.costs[sig] = ProgramCost(sig=sig, kind=kind,
                                                  steps=int(steps))
        rec.kind = kind
        rec.steps = int(steps)
        if compile_s is not None:
            rec.compile_s = float(compile_s)
        if cost:
            # The memory ledger rides independently of the flops report.
            for field in ("argument_bytes", "temp_bytes",
                          "generated_code_bytes"):
                if cost.get(field) is not None:
                    setattr(rec, field, int(cost[field]))
        analytic = None
        if _STATE.analytic_flops_per_step is not None:
            analytic = float(_STATE.analytic_flops_per_step) * int(steps)
        if cost and cost.get("flops"):
            rec.flops = float(cost["flops"])
            rec.bytes_accessed = cost.get("bytes_accessed")
            rec.output_bytes = cost.get("output_bytes")
            rec.source = cost.get("source") or "fake-trace"
            # Each accounting is a LOWER bound on what executes, so take
            # whichever sees more.
            if analytic is not None and analytic > rec.flops:
                rec.flops = analytic
                rec.source = "analytic"
        elif analytic is not None:
            rec.flops = analytic
            rec.source = "analytic"
        return rec


def program_costs() -> Dict[str, ProgramCost]:
    """A point-in-time copy of the per-signature cost cache."""
    with _STATE.lock:
        return dict(_STATE.costs)


# ------------------------------------------------------------- attribution

# Span-name -> phase classification. ``train.dispatch`` is the gross host
# cost of one step's feed/dispatch work (it wraps shard_batch + the enqueue
# + any synchronous PS exchange); ``ps.*`` spans nested inside it are pulled
# out as ``comm``, and the unrolled loop's ``runner.shard_block`` spans —
# recorded in gather(), OUTSIDE train.dispatch — are added back in (block
# stacking + h->d transfer is host work even when it overlaps the device;
# the attribution is a host-timeline decomposition). Outside train() (a
# bare runner loop) the dispatch spans themselves stand in for the host
# phase.
_HOST_SPANS = ("train.dispatch",)
_HOST_SIBLING_SPANS = ("runner.shard_block",)
_HOST_FALLBACK_SPANS = ("runner.run.dispatch", "runner.run_many.dispatch",
                        "runner.shard_batch", "runner.shard_block",
                        "jit.compile")


def _period_span_seconds(since_ns: int) -> Dict[str, float]:
    """Sum span durations since ``since_ns`` into phase buckets (seconds)."""
    (_, _, names, _, name_idx, _, t0s, durs, _,
     _, _, _) = _spans._export_columns(since_ns)
    by_name: Dict[str, float] = {}
    for n, dur in zip(name_idx, durs):
        name = names[n]
        by_name[name] = by_name.get(name, 0.0) + dur
    data_wait = by_name.get("train.data_wait", 0.0)
    readback = by_name.get("train.readback_wait", 0.0)
    comm = sum(v for k, v in by_name.items() if k.startswith("ps."))
    host = sum(by_name.get(k, 0.0) for k in _HOST_SPANS)
    if host:
        # ps.* exchanges run nested inside train.dispatch — pull them out so
        # comm is not double-counted as host; gather()'s shard_block spans
        # are train.dispatch SIBLINGS, so they add.
        host = max(0.0, host - comm) \
            + sum(by_name.get(k, 0.0) for k in _HOST_SIBLING_SPANS)
    else:
        host = sum(by_name.get(k, 0.0) for k in _HOST_FALLBACK_SPANS)
    return {"data_wait": data_wait / 1e9, "host": host / 1e9,
            "comm": comm / 1e9, "readback": readback / 1e9}


def observe_period(step: Optional[int] = None,
                   require_steps: bool = False) -> Optional[Dict[str, Any]]:
    """Close one attribution period at a train-loop log boundary.

    Joins the period's span durations against its dispatched program costs
    and books the gauges: ``train.attr.<phase>`` (fractions of period wall
    time, summing to 1.0 — ``compute`` is the unexplained residual, i.e. the
    host parked behind the device, or on a card the device time of the
    period's dispatches, :func:`_device_parts`), ``train.mfu`` / ``train.membw_util``
    (achieved over :func:`peak_spec` peaks, only when both sides are known)
    and ``train.flops_per_s``. Returns the period record (appended to the
    profile's series), or None when profiling is off or the period is
    degenerate (zero wall time).

    ``require_steps=True`` (the end-of-run flush) drops a period that saw
    NO dispatches — a run whose last boundary just closed would otherwise
    append a step-less tail (checkpoint/teardown wall time) that distorts
    the period-weighted summary."""
    if not _STATE.enabled:
        return None
    now_ns = time.perf_counter_ns()
    with _STATE.lock:
        start_ns = _STATE.period_start_ns
        _STATE.period_start_ns = now_ns
        if start_ns is None or now_ns <= start_ns:
            return None
        # Dispatch deltas since the last boundary, joined against costs.
        flops = bytes_acc = 0.0
        steps = dispatches = 0
        flops_known = True
        for sig, rec in _STATE.costs.items():
            delta = rec.dispatches - _STATE.last_dispatches.get(sig, 0)
            if delta <= 0:
                continue
            _STATE.last_dispatches[sig] = rec.dispatches
            dispatches += delta
            steps += delta * rec.steps
            if rec.flops is not None:
                flops += delta * rec.flops
                if rec.bytes_accessed is not None:
                    bytes_acc += delta * rec.bytes_accessed
            else:
                flops_known = False
    if require_steps and steps == 0:
        return None
    period_s = (now_ns - start_ns) / 1e9
    measured = _period_span_seconds(start_ns)
    device_s = _drain_device_seconds()
    if device_s is not None:
        parts = _device_parts(measured, period_s, device_s)
    else:
        # Residual = wall time not explained by any instrumented host
        # phase: the loop parked behind the device (or uninstrumented host
        # work). Clamped at 0 when overlapped background threads (the PS
        # prefetch socket) make measured phase time exceed wall time;
        # normalizing by the parts' sum keeps the shares a distribution
        # either way.
        residual = max(0.0, period_s - sum(measured.values()))
        parts = dict(measured, compute=residual)
    total = sum(parts.values())
    if total <= 0:
        return None
    shares = {k: parts[k] / total for k in ATTR_PHASES}
    peaks = peak_spec()
    flops_per_s = (flops / period_s) if flops else None
    bytes_per_s = (bytes_acc / period_s) if bytes_acc else None
    mfu = (flops_per_s / peaks.flops_per_s
           if flops_per_s and peaks.flops_per_s else None)
    membw = (bytes_per_s / peaks.membw_bytes_per_s
             if bytes_per_s and peaks.membw_bytes_per_s else None)
    record: Dict[str, Any] = {
        "step": step,
        "period_s": round(period_s, 6),
        "steps": steps,
        "dispatches": dispatches,
        "steps_per_s": round(steps / period_s, 4) if steps else None,
        "shares": {k: round(v, 4) for k, v in shares.items()},
        "flops_per_s": flops_per_s,
        "bytes_per_s": bytes_per_s,
        "flops_known": flops_known,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "membw_util": round(membw, 4) if membw is not None else None,
    }
    for phase in ATTR_PHASES:
        _metrics.gauge(f"train.attr.{phase}").set(record["shares"][phase])
    if flops_per_s is not None:
        _metrics.gauge("train.flops_per_s").set(flops_per_s)
    if mfu is not None:
        _metrics.gauge("train.mfu").set(record["mfu"])
    if membw is not None:
        _metrics.gauge("train.membw_util").set(record["membw_util"])
    with _STATE.lock:
        _STATE.periods.append(record)
        if len(_STATE.periods) > _MAX_PERIODS:
            del _STATE.periods[0]
    return record


def attribution_periods() -> List[Dict[str, Any]]:
    """A copy of the recorded per-period attribution series."""
    with _STATE.lock:
        return list(_STATE.periods)


_SHARE_ABBREV = {"compute": "comp", "comm": "comm", "host": "host",
                 "data_wait": "data", "readback": "rb"}


def format_shares(shares: Dict[str, float]) -> str:
    """``comp .61 comm .05 host .22 data .07 rb .05`` — the ONE compact
    share rendering, shared by the ``train:`` log-line suffix and adtop's
    ``perf`` line so the two can never drift. Phases absent from ``shares``
    are skipped (adtop renders whatever gauges the run booked)."""
    return " ".join(
        f"{_SHARE_ABBREV[k]} {shares[k]:.2f}".replace(" 0.", " .")
        for k in ATTR_PHASES if k in shares)


def format_attr_line(record: Optional[Dict[str, Any]]) -> str:
    """The compact ``train:`` log-line suffix for one period record:
    ``mfu 28.3% | comp .61 comm .05 host .22 data .07 rb .05`` (phases
    abbreviated, mfu omitted when unknown)."""
    if not record:
        return ""
    mfu = record.get("mfu")
    head = f"mfu {100.0 * mfu:.1f}% | " if mfu is not None else ""
    return f" | {head}{format_shares(record['shares'])}"


# ------------------------------------------------------------ profile store

def _summary(periods: List[Dict[str, Any]],
             costs: Dict[str, ProgramCost]) -> Dict[str, Any]:
    """Period_s-weighted aggregate of the attribution series plus per-step
    cost averages — the numbers adprof diffs and costmodel calibrates on."""
    total_s = sum(p["period_s"] for p in periods)
    total_steps = sum(p["steps"] for p in periods)
    total_disp = sum(p["dispatches"] for p in periods)
    out: Dict[str, Any] = {
        "wall_s": round(total_s, 6),
        "steps": total_steps,
        "dispatches": total_disp,
        "steps_per_s": round(total_steps / total_s, 4)
        if total_s and total_steps else None,
        "step_s": round(total_s / total_steps, 6)
        if total_steps else None,
    }
    if total_s:
        shares = {k: sum(p["shares"][k] * p["period_s"] for p in periods)
                  / total_s for k in ATTR_PHASES}
        out["shares"] = {k: round(v, 4) for k, v in shares.items()}
        mfus = [(p["mfu"], p["period_s"]) for p in periods
                if p.get("mfu") is not None]
        if mfus:
            out["mfu"] = round(sum(m * w for m, w in mfus)
                               / sum(w for _, w in mfus), 4)
        bw = [(p["membw_util"], p["period_s"]) for p in periods
              if p.get("membw_util") is not None]
        if bw:
            out["membw_util"] = round(sum(m * w for m, w in bw)
                                      / sum(w for _, w in bw), 4)
    flops = sum((r.flops or 0.0) * r.dispatches for r in costs.values())
    bytes_acc = sum((r.bytes_accessed or 0.0) * r.dispatches
                    for r in costs.values())
    run_steps = sum(r.steps * r.dispatches for r in costs.values())
    if run_steps:
        out["flops_per_step"] = flops / run_steps if flops else None
        out["bytes_per_step"] = bytes_acc / run_steps if bytes_acc else None
    if total_disp and total_steps and out.get("step_s") and out.get("shares"):
        # Host seconds per dispatch: what the cost model charges each
        # program launch (dispatch amortization is why unroll=K wins).
        out["host_s_per_dispatch"] = round(
            out["shares"]["host"] * out["step_s"] * total_steps / total_disp,
            9)
    return out


def profile_document(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The in-memory profile: schema header, env manifest (the flight
    recorder's helper), hardware peaks, per-signature program costs, the
    attribution series, and the weighted summary."""
    from autodist_tpu_torch.telemetry import recorder as _recorder
    periods = attribution_periods()
    costs = program_costs()
    doc: Dict[str, Any] = {
        "schema": PROFILE_SCHEMA,
        "schema_version": PROFILE_SCHEMA_VERSION,
        "manifest": _recorder.build_manifest("profile"),
        "peaks": peak_spec().to_dict(),
        "programs": {sig: rec.to_dict() for sig, rec in sorted(costs.items())},
        "periods": periods,
        "summary": _summary(periods, costs),
    }
    plan = applied_plan()
    if plan:
        # Which execution plan produced these numbers (autotuner record:
        # cache key + knobs + predicted vs measured) — so adprof diffs can
        # say "the regression is plan A vs plan B", not just "it got slower".
        doc["plan"] = plan
    # PS-wire traffic, when the run mirrored any (the registry's ps.wire.*
    # counters): costmodel.calibrate derives the measured wire bandwidth
    # from these + the comm share — the interconnect term of predict().
    snap = _metrics.snapshot()
    wire = {key: snap[f"ps.wire.{key}"] for key in
            ("bytes_sent", "bytes_received", "bytes_saved",
             "bytes_quantized")
            if isinstance(snap.get(f"ps.wire.{key}"), (int, float))
            and snap[f"ps.wire.{key}"] > 0}
    # The compressor's host seconds live under its own wire.* prefix (it is
    # not transport traffic); calibrate's quantize_bytes_per_s fit reads
    # bytes_quantized / quantize_s out of this same block.
    qs = snap.get("wire.quantize_s")
    if isinstance(qs, (int, float)) and qs > 0:
        wire["quantize_s"] = qs
    if wire:
        doc["wire"] = wire
    if extra:
        doc.update(extra)
    return doc


def write_profile(path: str,
                  extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the per-run profile JSON to ``path``; returns ``path``. The
    document is self-contained — ``tools/adprof.py`` and
    :mod:`telemetry.costmodel` read it with no live process."""
    doc = profile_document(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    logging.info("profiling: wrote profile (%d program(s), %d period(s)) "
                 "to %s", len(doc["programs"]), len(doc["periods"]), path)
    return path


_WRITE_SEQ = 0


def maybe_write_profile() -> Optional[str]:
    """End-of-run hook (``train()`` calls it): write a profile into
    ``AUTODIST_PROFILE_DIR`` when profiling is active and the flag names a
    directory; no-op (None) otherwise. A failed write logs and returns None —
    diagnostics must never take down the run they describe."""
    global _WRITE_SEQ
    if not _STATE.enabled:
        return None
    out_dir = str(const.ENV.AUTODIST_PROFILE_DIR.val)
    if not out_dir:
        return None
    proc = int(const.ENV.AUTODIST_PROCESS_ID.val)
    try:
        os.makedirs(out_dir, exist_ok=True)
        # pid + per-process seq: concurrent runs sharing a dir never clobber
        # (the recorder's snap-dir collision class).
        path = os.path.join(
            out_dir, f"profile-w{proc}-p{os.getpid()}-{_WRITE_SEQ:03d}.json")
        _WRITE_SEQ += 1
        return write_profile(path)
    except (OSError, ValueError, TypeError) as e:
        logging.warning("profiling: profile write failed: %s", e)
        return None


# AUTODIST_PROFILE=1 arms the attribution plane at import (and with it span
# recording), mirroring AUTODIST_TELEMETRY's contract — worker processes
# launched with an inherited env profile without code changes.
if const.ENV.AUTODIST_PROFILE.val:
    enable()
