"""Training-health monitors: on-device numerics plane + host-side policy.

A NaN that enters the parameters propagates silently — through reduce-scatter
under ZeRO sharding, through every later step's gradients — until someone
notices the loss curve days later. This module makes numeric health a
first-class per-step signal with ZERO extra dispatches:

- **Device side** (:func:`device_bundle`): inside the step
  (``runner._step``), one scalar bundle is computed on the card from the
  step's own tensors — non-finite count over gradients+loss, global
  gradient norm, update norm, parameter norm. ``torch.optim`` updates in
  place, so the update is the change the step made: the runner keeps a copy
  of the trainable tensors from before the step, only while health is on.
  The bundle stays on the card until the loop's log boundary reads it;
  ``unroll=K`` blocks reduce it inside their captured graph
  (:func:`reduce_bundle`) so a K-step block still reads back four scalars.
- **Host side** (:class:`HealthMonitor`): ``train()`` feeds the monitor at
  its EXISTING log boundaries (where the loss readback already syncs — the
  bundle readback is free), and the monitor books ``train.health.*`` gauges,
  runs an EWMA z-score loss-spike detector over the period's per-step losses,
  records structured ``health.anomaly`` events, and applies the
  ``AUTODIST_HEALTH_ACTION`` policy: ``warn`` logs, ``record`` captures a
  flight-recorder snapshot (:mod:`autodist_tpu_torch.telemetry.recorder`), ``halt``
  raises :class:`HealthHalt` with the current :class:`TrainState` attached so
  the caller can checkpoint or inspect it.

Cost contract: with ``AUTODIST_HEALTH`` off (the default) the step is
UNCHANGED (the runner pays one attribute read: no launch, no tensor) and
the train loop pays one ``is None`` check per step. Enabled, the bundle is
the parameter copy and a handful of multi-tensor reductions; monitored and
unmonitored runs produce BIT-IDENTICAL parameters because the bundle only
reads the step's tensors.
"""

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.utils import logging

__all__ = ["BUNDLE_FIELDS", "device_bundle", "bundle_of", "sq_norm", "reduce_bundle",
           "HealthConfig",
           "HealthMonitor", "HealthHalt", "HealthRecover"]

# The fused scalar bundle's layout (one f32 per field, this order). Kept
# tiny on purpose: the readback rides the log boundary's existing sync.
BUNDLE_FIELDS = ("nonfinite", "grad_norm", "update_norm", "param_norm")

ACTIONS = ("warn", "record", "halt", "recover")


class HealthHalt(RuntimeError):
    """Raised by ``train()`` under ``AUTODIST_HEALTH_ACTION=halt``: a health
    anomaly stopped the run. Carries ``step`` (the global step at the
    boundary that observed it), ``state`` (the live :class:`TrainState` —
    intact, so the caller can checkpoint or autopsy it), and ``anomalies``
    (the structured records that tripped the halt)."""

    def __init__(self, step: int, state, anomalies: List[Dict[str, Any]]):
        kinds = ",".join(sorted({a["kind"] for a in anomalies}))
        super().__init__(
            f"training halted at step {step}: health anomaly ({kinds}); "
            f"the live TrainState rides on this exception as `.state`")
        self.step = step
        self.state = state
        self.anomalies = anomalies


class HealthRecover(HealthHalt):
    """The ``recover`` action's control signal, raised at the anomalous
    boundary and CAUGHT INSIDE ``train()``: the loop rolls back to the
    newest last-known-good snapshot (``parallel/recovery.py``'s ring) and
    resumes, escalating to a plain :class:`HealthHalt` after
    ``AUTODIST_RECOVER_MAX`` attempts. A :class:`HealthHalt` subclass so
    a bare ``except HealthHalt`` in a caller that drives the loop pieces
    directly still observes it (same payload: step/state/anomalies)."""


def _float_tensors(tree):
    """The floating tensors of a tensor, or of a dict, list or tuple of them."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for sub in tree for t in _float_tensors(sub)]


def sq_norm(tensors, weights=None, device=None):
    """The f32 sum of squares of ``tensors`` (each cast to f32; a 0-dim
    tensor on ``device`` when there are none), each tensor's term divided by
    its weight when ``weights`` is given: one multi-tensor norm launch, then
    the sum of the squared norms."""
    import torch
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    norms = torch._foreach_norm([t.detach() if t.dtype == torch.float32
                                 else t.detach().float() for t in tensors], 2)
    sq = torch.stack(norms).square()
    if weights is not None:
        sq = sq / torch.tensor(weights, dtype=torch.float32, device=sq.device)
    return sq.sum()


def device_bundle(grads, updates, params, loss, weights=None, group=None):
    """The fused health bundle, computed on the step's device from its own
    tensors and never read back there: a float32[4] of (non-finite probe
    count, global grad L2 norm, update L2 norm, parameter L2 norm). Three
    multi-tensor reductions, no host sync.

    ``grads``, ``updates`` and ``params`` are tensors or dicts/lists of them
    (``updates`` the change the step made, ``params`` before it). Non-finite
    detection rides the norms: any NaN/Inf in a tree propagates into its sum
    of squares, so ``nonfinite`` counts how many of the four probes
    (grad/update/param squared norms and the loss) went non-finite. A squared
    norm that OVERFLOWS f32 (a true norm above ~1e19) also flags, as in the
    JAX package. Integer and bool tensors are skipped.

    Sharded state: ``weights`` (three lists, one per tree, in its tensor
    order) holds each tensor's replication count over ``group`` — the ranks
    that hold the same shard — and the three weighted partial sums are summed
    over ``group`` with one all-reduce, so every element of the global tensor
    counts once."""
    import torch
    trees = [_float_tensors(t) for t in (grads, updates, params)]
    ref = next((ts[0] for ts in trees if ts), None)
    device = ref.device if ref is not None else torch.device("cpu")
    return bundle_of([sq_norm(ts, None if weights is None else weights[i], device)
                      for i, ts in enumerate(trees)], loss, group)


def bundle_of(squares, loss, group=None):
    """The bundle from the three (partial) squared norms: summed over
    ``group`` with one all-reduce when given, then the non-finite count over
    them and the loss, and their square roots."""
    import torch
    sq = torch.stack(squares)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sq, group=group)
    probes = torch.cat([sq, torch.as_tensor(loss, dtype=torch.float32,
                                            device=sq.device).detach().reshape(1)])
    nonfinite = (~torch.isfinite(probes)).sum().to(torch.float32)
    return torch.cat([nonfinite.reshape(1), sq.sqrt()])


def reduce_bundle(stacked):
    """Reduce a ``[K, 4]`` per-step bundle stack (an ``unroll=K`` block) to
    one ``[4]`` bundle on the device, inside the captured block: non-finite
    counts SUM over the block (any step's NaN survives the reduction), the
    norms take their block MAX (the worst step is the anomaly signal)."""
    import torch
    return torch.cat([stacked[:, :1].sum(dim=0), stacked[:, 1:].amax(dim=0)])


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Monitor knobs (defaults from the ``AUTODIST_HEALTH*`` flags via
    :meth:`from_env`)."""

    action: str = "warn"   # AUTODIST_HEALTH_ACTION: warn|record|halt|recover
    z_max: float = 6.0          # AUTODIST_HEALTH_ZMAX: loss-spike threshold
    ewma_decay: float = 0.9     # EWMA decay for the loss mean/variance
    warmup: int = 8             # losses observed before z-scores can fire

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown health action {self.action!r}; "
                             f"valid: {', '.join(ACTIONS)}")
        if not (0.0 < self.ewma_decay < 1.0):
            raise ValueError("ewma_decay must be in (0, 1)")

    @staticmethod
    def from_env(**overrides) -> "HealthConfig":
        base = dict(action=str(const.ENV.AUTODIST_HEALTH_ACTION.val),
                    z_max=const.ENV.AUTODIST_HEALTH_ZMAX.val)
        base.update(overrides)
        return HealthConfig(**base)


class HealthMonitor:
    """Host-side consumer of the device bundle + per-step losses.

    ``train()`` calls :meth:`observe` at every log boundary with the period's
    per-step losses (already synced for the throughput log line) and the
    runner's latest bundle readback. The monitor:

    - books ``train.health.{grad_norm,update_ratio,param_norm,nonfinite,
      loss_z}`` gauges and a ``train.health.grad_norm`` histogram,
    - detects NON-FINITE numerics (bundle count > 0, or a NaN/Inf boundary
      loss) and LOSS SPIKES (EWMA z-score of a finite loss above ``z_max``,
      after ``warmup`` observations),
    - records a structured ``health.anomaly`` event per finding and bumps
      ``train.health.anomalies``,
    - applies the action policy: ``warn`` logs a rate-limited warning;
      ``record`` captures a flight-recorder snapshot (the recorder is
      created on demand when none is installed); ``halt`` additionally makes
      :attr:`should_halt` true — ``train()`` raises :class:`HealthHalt` with
      the live state (the monitor never owns the state, so the raise happens
      at the call site).

    One monitor per ``train()`` call; it is NOT thread-safe (the train loop
    is its only caller).
    """

    WARN_EVERY_S = 60.0

    def __init__(self, config: Optional[HealthConfig] = None, recorder=None):
        self.config = config or HealthConfig.from_env()
        self._recorder = recorder   # None -> resolved lazily on first record
        reg = _metrics.registry()
        self._g = {f: reg.gauge(f"train.health.{f}")
                   for f in ("grad_norm", "update_ratio", "param_norm",
                             "nonfinite", "loss_z")}
        # Distribution next to the last-value gauge (the `.dist` suffix keeps
        # the name inside the NORM_BUCKETS family and out of the gauge's).
        self._grad_hist = reg.histogram("train.health.grad_norm.dist")
        self._anomaly_counter = reg.counter("train.health.anomalies")
        self._ewma: Optional[float] = None
        self._ewvar = 0.0
        self._seen = 0
        self._last_warn = -math.inf
        self.anomalies: List[Dict[str, Any]] = []   # every anomaly observed

    @property
    def should_halt(self) -> bool:
        return bool(self.anomalies) and self.config.action == "halt"

    @property
    def should_recover(self) -> bool:
        """True under ``action=recover`` with anomalies observed — the train
        loop's cue to raise :class:`HealthRecover` at the boundary (the
        monitor never owns the state, so the raise happens at the call
        site, exactly like ``should_halt``)."""
        return bool(self.anomalies) and self.config.action == "recover"

    @staticmethod
    def from_env(recorder=None) -> Optional["HealthMonitor"]:
        """The train-loop entry point: a monitor when ``AUTODIST_HEALTH`` is
        on, else None (the loop's disabled cost is one ``is None`` check)."""
        if not const.ENV.AUTODIST_HEALTH.val:
            return None
        return HealthMonitor(recorder=recorder)

    # ------------------------------------------------------------- detection

    def observe(self, step: int, losses: Sequence[float],
                bundle=None) -> List[Dict[str, Any]]:
        """Consume one log period: ``losses`` are the period's per-step loss
        values (host floats/ndarray), ``bundle`` the latest device-bundle
        readback (``float32[4]`` per :data:`BUNDLE_FIELDS`, or None when the
        runner computes no bundle). Returns the period's NEW anomaly records
        (empty when healthy)."""
        found: List[Dict[str, Any]] = []
        if bundle is not None:
            b = np.asarray(bundle, np.float64).reshape(-1)
            nonfinite = float(b[0]) if math.isfinite(float(b[0])) else 1.0
            grad_norm, update_norm, param_norm = (float(b[1]), float(b[2]),
                                                  float(b[3]))
            ratio = update_norm / max(param_norm, 1e-12)
            self._g["grad_norm"].set(grad_norm)
            self._g["update_ratio"].set(round(ratio, 8))
            self._g["param_norm"].set(param_norm)
            self._g["nonfinite"].set(nonfinite)
            if math.isfinite(grad_norm):
                self._grad_hist.observe(grad_norm)
            if nonfinite > 0 or not math.isfinite(grad_norm):
                found.append({"kind": "nonfinite", "step": step,
                              "nonfinite": nonfinite,
                              "grad_norm": grad_norm})
        for loss in np.asarray(losses, np.float64).reshape(-1):
            loss = float(loss)
            if not math.isfinite(loss):
                if not any(a["kind"] == "nonfinite" and a["step"] == step
                           for a in found):
                    found.append({"kind": "nonfinite", "step": step,
                                  "loss": loss})
                continue
            z = self._z_score(loss)
            self._g["loss_z"].set(round(z, 4))
            if self._seen > self.config.warmup and z > self.config.z_max:
                found.append({"kind": "loss_spike", "step": step,
                              "loss": round(loss, 6), "z": round(z, 3)})
            self._update_ewma(loss)
        if found:
            self._react(step, found)
        return found

    def _z_score(self, loss: float) -> float:
        if self._ewma is None or self._ewvar <= 0.0:
            return 0.0
        return (loss - self._ewma) / math.sqrt(self._ewvar)

    def _update_ewma(self, loss: float):
        self._seen += 1
        if self._ewma is None:
            self._ewma = loss
            return
        d = self.config.ewma_decay
        delta = loss - self._ewma
        self._ewma += (1.0 - d) * delta
        # EW variance (West 1979 form): tracks the loss's own scatter, so the
        # z threshold adapts to noisy objectives instead of a fixed epsilon.
        self._ewvar = d * (self._ewvar + (1.0 - d) * delta * delta)

    # ---------------------------------------------------------------- policy

    def _react(self, step: int, found: List[Dict[str, Any]]):
        import time
        from autodist_tpu_torch import telemetry
        from autodist_tpu_torch.telemetry import recorder as _recorder
        self.anomalies.extend(found)
        for a in found:
            self._anomaly_counter.inc()
            telemetry.event("health.anomaly", **a)
        kinds = ",".join(sorted({a["kind"] for a in found}))
        if self.config.action == "record":
            # record EXPLICITLY asks for snapshots: arm a default recorder
            # on demand when none was supplied or installed.
            if self._recorder is None:
                self._recorder = _recorder.get_or_create()
            path = self._recorder.maybe_record(f"health.{kinds}")
        elif self._recorder is not None:
            # warn/halt with a constructor-supplied recorder: honor it.
            path = self._recorder.maybe_record(f"health.{kinds}")
        else:
            # warn/halt otherwise snapshot only through an ARMED recorder
            # (AUTODIST_RECORDER=1 or telemetry.set_recorder) — the anomaly
            # event is the trigger, the action only decides how loudly to
            # react; un-armed, halt just raises and warn just logs.
            path = _recorder.maybe_record(f"health.{kinds}")
        if path:
            logging.warning("train: health anomaly (%s) at step %d — "
                            "flight-recorder snapshot at %s",
                            kinds, step, path)
            return
        now = time.monotonic()
        if now - self._last_warn >= self.WARN_EVERY_S:
            self._last_warn = now
            logging.warning("train: health anomaly (%s) at step %d: %s",
                            kinds, step, found[-1])
