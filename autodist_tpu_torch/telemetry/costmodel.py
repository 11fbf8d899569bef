"""Calibrated step-time cost model over static program costs (the port's
copy of ``autodist_tpu/telemetry/costmodel.py:31-261``, same arithmetic).

The strategy search ranks candidate plans without running each to steady
state. Its two ingredients:

- **static costs**: per-program FLOPs and bytes from
  ``DistributedRunner.plan_costs`` (a trace on fake tensors; no step runs);
- **a calibration record**: the machine's *achieved* rates (FLOP/s,
  bytes/s, host seconds per dispatch, wire bytes/s), fitted from a real
  run, so systematic model error cancels between candidates.

:func:`predict` prices a plan: the roofline per program
(``max(flops/flops_per_s, bytes/bytes_per_s)``), host seconds per dispatch
(what ``unroll=K`` amortizes) and a wire term for plans that cross the PS
transport. In eager PyTorch every op that launches work on the card is a
host dispatch, so a record may carry ``launches``, the launches one
dispatch of the program makes (an eager step: each such op; a CUDA graph
replay of K steps: 1); ``host_s_per_dispatch`` is then host seconds per
launch. A
record without it counts one, so the JAX package's records price exactly
as they do there.
"""

import dataclasses
from typing import Any, Dict, Iterable, Optional, Union

__all__ = ["Calibration", "calibrate", "predict", "predict_from_profile"]


@dataclasses.dataclass
class Calibration:
    """Achieved machine rates fitted from one profile (see :func:`calibrate`).

    ``flops_per_s``/``bytes_per_s`` are the rates the device actually
    sustained during the profiled run's compute phase — NOT hardware peaks;
    ``host_s_per_dispatch`` is the host-side cost of one program launch
    (feed sharding + enqueue); ``wire_bytes_per_s`` is the measured PS-wire
    bandwidth (None for collective-only runs); ``quantize_bytes_per_s`` is
    the host's achieved gradient quantize rate (dense bytes in per second
    of ``wire.quantize_s``), fitted like ``host_s_per_dispatch`` — the cost
    side of wire compression, so :func:`predict` can refuse a wire_dtype
    whose quantize seconds exceed the wire seconds it saves (None until a
    compressed run has been profiled)."""

    flops_per_s: Optional[float] = None
    bytes_per_s: Optional[float] = None
    host_s_per_dispatch: float = 0.0
    wire_bytes_per_s: Optional[float] = None
    quantize_bytes_per_s: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Calibration":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _wire_bytes_per_s(profile: Dict[str, Any]) -> Optional[float]:
    """Measured PS-wire bandwidth: the profile's ``wire`` block (the
    ``ps.wire.*`` registry counters ``profile_document`` attaches when the
    run mirrored any transport traffic) over the comm phase's wall seconds;
    None for collective-only runs, which cross no wire.

    SYMMETRIC-RATE ASSUMPTION, deliberate: ``bytes_sent + bytes_received``
    are lumped over ONE comm window, i.e. the fitted rate models a
    full-duplex link whose send and receive directions achieve the same
    bandwidth (true of the loopback and NIC fabrics this transport runs
    on; the overlapped client moves pull traffic off the comm window's
    critical path anyway). Callers that price an ASYMMETRICALLY compressed
    plan — a quantized push against an uncompressed pull — must therefore
    scale the per-DIRECTION byte counts before dividing by this rate
    (``strategy/autotune._wire_terms`` prices push and pull separately for
    exactly this reason); scaling the lumped total by the push ratio would
    skew the prediction by the pull share."""
    wire = profile.get("wire") or {}
    total_bytes = (wire.get("bytes_sent", 0) or 0) \
        + (wire.get("bytes_received", 0) or 0)
    summary = profile.get("summary") or {}
    shares = summary.get("shares") or {}
    comm_s = (shares.get("comm") or 0.0) * (summary.get("wall_s") or 0.0)
    if total_bytes and comm_s > 0:
        return total_bytes / comm_s
    return None


def _quantize_bytes_per_s(profile: Dict[str, Any]) -> Optional[float]:
    """Achieved host quantize rate: dense gradient bytes the compressor
    consumed (``ps.wire.bytes_quantized``) over its cumulative
    ``wire.quantize_s``; None when the profiled run never compressed."""
    wire = profile.get("wire") or {}
    qbytes = wire.get("bytes_quantized", 0) or 0
    qs = wire.get("quantize_s", 0.0) or 0.0
    if qbytes and qs > 0:
        return qbytes / qs
    return None


def calibrate(profile: Dict[str, Any]) -> Calibration:
    """Fit a :class:`Calibration` from one profile document (the dict
    :func:`telemetry.write_profile` wrote / ``profile_document`` returned).

    The compute phase's wall seconds anchor the achieved rates: the profiled
    run dispatched ``flops_per_step * steps`` flops and its loop sat parked
    behind the device for ``compute_share * wall_s`` seconds, so the
    sustained rate is their quotient (same for bytes). Degenerate profiles
    (no compute residual — a fully host-bound run) fall back to whole-wall
    rates, which keeps predictions conservative rather than infinite."""
    summary = profile.get("summary") or {}
    shares = summary.get("shares") or {}
    wall_s = summary.get("wall_s") or 0.0
    steps = summary.get("steps") or 0
    compute_s = (shares.get("compute") or 0.0) * wall_s
    if compute_s <= 0:
        compute_s = wall_s
    flops_step = summary.get("flops_per_step")
    bytes_step = summary.get("bytes_per_step")
    return Calibration(
        flops_per_s=(flops_step * steps / compute_s)
        if flops_step and steps and compute_s > 0 else None,
        bytes_per_s=(bytes_step * steps / compute_s)
        if bytes_step and steps and compute_s > 0 else None,
        host_s_per_dispatch=summary.get("host_s_per_dispatch") or 0.0,
        wire_bytes_per_s=_wire_bytes_per_s(profile),
        quantize_bytes_per_s=_quantize_bytes_per_s(profile),
    )


def predict(plan_costs: Union[Dict[str, Any], Iterable[Dict[str, Any]]],
            calib: Calibration,
            comm_bytes_per_step: float = 0.0,
            loader_s_per_step: float = 0.0,
            prefetch_depth: int = 0,
            quantize_bytes_per_step: float = 0.0,
            resident_bytes: float = 0.0) -> Dict[str, Any]:
    """Predict per-step time for a candidate plan's program set.

    ``plan_costs``: one program-cost dict or an iterable of them — the
    ``{"flops", "bytes_accessed", "steps", "dispatches"}`` records a
    profile's ``programs`` table holds, flops/bytes PER DISPATCH (a
    ``steps=K`` fused block counts as one dispatch advancing K steps;
    ``dispatches`` defaults to 1 and weights the program's contribution).
    Per dispatch the device time is the roofline ``max(flops/flops_per_s,
    bytes/bytes_per_s)`` — whichever resource binds — plus
    ``calib.host_s_per_dispatch`` for each of the record's ``launches``
    (default 1); ``comm_bytes_per_step``
    over the calibrated wire bandwidth adds the PS transfer term.

    ``comm_bytes_per_step`` must already reflect any wire compression (the
    caller scales the push direction by its compression ratio — see the
    ``_wire_bytes_per_s`` direction note); ``quantize_bytes_per_step`` is
    the DENSE bytes the compressor must quantize per step, priced over
    ``calib.quantize_bytes_per_s`` as host seconds — the cost side of the
    trade, so compression only predicts faster when the wire seconds saved
    exceed the quantize seconds added.

    ``loader_s_per_step`` prices the input pipeline: with
    ``prefetch_depth == 0`` (the synchronous feed) the loader's full
    per-step seconds land in the step; with ``prefetch_depth >= 1`` the
    async producer overlaps loading with the rest of the step, so only
    the RESIDUAL ``max(0, loader_s - hidden_s)`` remains, where
    ``hidden_s`` is everything the pipeline can hide behind (device +
    host + comm per step) — the steady-state bound: a pipeline of any
    depth >= 1 sustains ``max(rest_s, loader_s)`` per step.

    ``resident_bytes`` is the plan's per-device resident state (params +
    optimizer state + whatever else stays allocated across steps); with it
    the prediction also carries ``peak_hbm_bytes`` — resident plus the
    WORST program's transient working set (``max`` over the records'
    ``temp_bytes``, falling back to ``argument_bytes + output_bytes`` when
    the backend reported no temp ledger) — the fit estimate the autotuner's
    OOM pre-flight prices against the device budget before spending a
    compile probe.

    Returns ``{"step_s", "steps_per_s", "bound", "peak_hbm_bytes",
    "breakdown": {compute_s, memory_s, host_s, comm_s, quantize_s,
    data_wait_s per step}}`` — ``bound`` names the binding resource, the
    MLPerf-style "what do I fix first" answer (``peak_hbm_bytes`` is None
    when neither resident bytes nor any memory ledger was given)."""
    if isinstance(plan_costs, dict):
        plan_costs = [plan_costs]
    compute_s = memory_s = device_s = 0.0
    host_s = 0.0
    total_steps = 0
    peak_temp: Optional[float] = None
    for rec in plan_costs:
        n = max(1, int(rec.get("dispatches") or 1))
        steps = int(rec.get("steps") or 1)
        total_steps += n * steps
        temp = rec.get("temp_bytes")
        if temp is None and (rec.get("argument_bytes") is not None
                             or rec.get("output_bytes") is not None):
            temp = (rec.get("argument_bytes") or 0) \
                + (rec.get("output_bytes") or 0)
        if temp is not None:
            peak_temp = max(peak_temp or 0.0, float(temp))
        launches = max(1, int(rec.get("launches") or 1))
        c = (rec.get("flops") or 0.0) / calib.flops_per_s \
            if calib.flops_per_s else 0.0
        m = (rec.get("bytes_accessed") or 0.0) / calib.bytes_per_s \
            if calib.bytes_per_s else 0.0
        compute_s += n * c
        memory_s += n * m
        device_s += n * max(c, m)
        host_s += n * launches * calib.host_s_per_dispatch
    total_steps = max(1, total_steps)
    comm_s = 0.0
    if comm_bytes_per_step and calib.wire_bytes_per_s:
        comm_s = comm_bytes_per_step / calib.wire_bytes_per_s
    quantize_s = 0.0
    if quantize_bytes_per_step and calib.quantize_bytes_per_s:
        quantize_s = quantize_bytes_per_step / calib.quantize_bytes_per_s
    hidden_s = device_s / total_steps + host_s / total_steps + comm_s \
        + quantize_s
    data_s = 0.0
    if loader_s_per_step > 0:
        data_s = max(0.0, loader_s_per_step - hidden_s) \
            if prefetch_depth >= 1 else float(loader_s_per_step)
    step_s = hidden_s + data_s
    breakdown = {"compute_s": compute_s / total_steps,
                 "memory_s": memory_s / total_steps,
                 "host_s": host_s / total_steps,
                 "comm_s": comm_s,
                 "quantize_s": quantize_s,
                 "data_wait_s": data_s}
    bound = max(("compute", breakdown["compute_s"]),
                ("memory", breakdown["memory_s"]),
                ("host", breakdown["host_s"]),
                ("comm", breakdown["comm_s"]),
                ("quantize", breakdown["quantize_s"]),
                ("data_wait", breakdown["data_wait_s"]),
                key=lambda kv: kv[1])[0] if step_s > 0 else "unknown"
    peak_hbm = None
    if resident_bytes or peak_temp is not None:
        peak_hbm = int(float(resident_bytes or 0.0) + (peak_temp or 0.0))
    return {"step_s": step_s,
            "steps_per_s": (1.0 / step_s) if step_s > 0 else None,
            "bound": bound,
            "peak_hbm_bytes": peak_hbm,
            "breakdown": breakdown}


def predict_from_profile(profile: Dict[str, Any],
                         calib: Optional[Calibration] = None) -> Dict[str, Any]:
    """Self-consistency probe: calibrate from ``profile`` (unless given) and
    predict ITS OWN program mix, weighting each program by its dispatch
    count. Returns the prediction plus ``measured_step_s`` and ``ratio``
    (predicted/measured) — the agreement the tests pin within a generous
    band, and the sanity check to run before trusting cross-plan ranking."""
    calib = calib if calib is not None else calibrate(profile)
    programs = profile.get("programs") or {}
    summary = profile.get("summary") or {}
    # One "plan unit" = every program, dispatch-weighted (predict() honors
    # the records' own dispatch counts) so rare programs — a one-off eval
    # signature — don't outvote the hot step.
    out = predict(list(programs.values()), calib)
    measured = summary.get("step_s")
    out["measured_step_s"] = measured
    out["ratio"] = (out["step_s"] / measured) \
        if measured and out["step_s"] else None
    out["calibration"] = calib.to_dict()
    return out
