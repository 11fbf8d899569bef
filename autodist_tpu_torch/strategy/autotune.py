"""Calibrated plan autotuner: predict, prune, probe, persist (the port's copy
of ``autodist_tpu/strategy/autotune.py``).

One two-stage search over the joint strategy x execution-knob space:

- :class:`~autodist_tpu_torch.strategy.auto_strategy.AutoStrategy`'s rules
  **generate candidates** (PS against collective, partitioned variants)
  jointly with the runtime's knobs: ``unroll=K`` (``run_many``, one CUDA
  graph replay a block on the card), ``zero`` and ``accumulation_steps``.
- **Stage 1 (predict and prune)** ranks every candidate with
  :func:`~autodist_tpu_torch.telemetry.costmodel.predict` over
  ``DistributedRunner.plan_costs`` (a trace on fake tensors: no step runs),
  with a :class:`~autodist_tpu_torch.telemetry.costmodel.Calibration` from
  an ``AUTODIST_PROFILE_DIR`` profile or the bundled one, measured on the
  H100; candidates predicted slower than the frontrunner by a margin are
  dropped unmeasured.
- **Stage 2 (probe)** runs a few real steps of at most ``top_k`` survivors
  through the tuner's :func:`~autodist_tpu_torch.strategy.tuner.measure_candidate`,
  and the measured winner is stored in the plan cache
  (``AUTODIST_PLAN_CACHE``: the JAX package's schema-versioned JSON, keyed
  by the model and batch signature, the device and the package), so a later
  launch of the same job applies it with no search.

``AutoDist(strategy_builder="autotune")`` and
``create_distributed_session(..., tune=True)`` are the entry points. The
search books the JAX package's ``tune.*`` spans, counters and gauges
(``tune.search``, ``tune.predict``, ``tune.compile_probe``, ``tune.probe``;
``tune.cache_hit``/``tune.cache_miss``; ``tune.candidates``,
``tune.pruned``, ``tune.pruned_oom``, ``tune.probed``,
``tune.best_steps_per_s``, ``tune.search_s``).

The port prices an eager step's host cost by its launches (``plan_costs``'
``launches``: the ATen ops of one step that launch work on the card, each a
host dispatch): a one-step candidate keeps its base record's launches, a
K-step candidate is one graph replay doing K steps' work
(:func:`_derive_record`).
"""

import dataclasses
import gc
import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder, num_devices
from autodist_tpu_torch.strategy.tuner import CandidateResult, measure_candidate
from autodist_tpu_torch.telemetry import costmodel

_log = logging.getLogger("autodist_tpu_torch")

__all__ = ["Candidate", "TunedPlan", "autotune", "enumerate_candidates",
           "plan_cache_key", "load_cached_plan", "store_plan", "builder_from_spec",
           "DEFAULT_CALIBRATION", "PLAN_SCHEMA", "PLAN_SCHEMA_VERSION"]

# The plan cache's JSON identity, the JAX package's (autotune.py:55-57).
PLAN_SCHEMA = "autodist-plan-cache"
PLAN_SCHEMA_VERSION = 1

# The unroll factors stage 1 ranks by default.
DEFAULT_UNROLLS = (1, 2, 4, 8)

# The prefetch depths ranked when the problem declares a loader cost
# (``loader_s_per_step > 0``); without one the knob collapses to (0,).
DEFAULT_PREFETCH_DEPTHS = (0, 2)

# Stage-1 prune margin: a candidate predicted more than this fraction slower
# than the frontrunner is dropped without measurement.
PRUNE_MARGIN = 0.35

# The bundled calibration, the H100's own (chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at 700.00 W, torch 2.11.0+cu128):
# - flops_per_s 1.806e14, bytes_per_s 2.082e12: the flagship's step at
#   384 x 256 x 8 (phase 9), plan_costs' 2.253e14 FLOPs and 2.598e12 bytes
#   over its measured 1.2477 s;
# - host_s_per_dispatch 5.488e-5: NCF at 65,536 under Parallax (phase 16):
#   the host's 3.842 ms to enqueue one run() step over plan_costs' 70
#   launches (ATen ops that launch work; the profiler counts 229 kernels).
# The wire and quantize rates price the async PS, which the port has not
# ported: None, which predict() reads as no term.
DEFAULT_CALIBRATION = costmodel.Calibration(
    flops_per_s=1.806e14, bytes_per_s=2.082e12, host_s_per_dispatch=5.488e-5,
    wire_bytes_per_s=None, quantize_bytes_per_s=None)

# The wire_dtype knob's axis for async candidates, and each value's push-byte
# ratio.
DEFAULT_WIRE_DTYPES = ("", "fp16", "int8")
_WIRE_RATIO = {"": 1.0, "fp16": 0.5, "bf16": 0.5, "int8": 0.26}

# Builders the autotuner may emit, by name: what a cached plan can name.
_BUILDERS: Dict[str, Callable[..., StrategyBuilder]] = {}


def _builder_registry() -> Dict[str, Callable[..., StrategyBuilder]]:
    if not _BUILDERS:
        from autodist_tpu_torch.strategy import (PS, AllReduce, AutoStrategy, Parallax,
                                                 PartitionedAR, PartitionedPS,
                                                 PSLoadBalancing)
        _BUILDERS.update({
            "AllReduce": AllReduce, "PSLoadBalancing": PSLoadBalancing,
            "AutoStrategy": AutoStrategy, "Parallax": Parallax,
            "PartitionedAR": PartitionedAR, "PartitionedPS": PartitionedPS, "PS": PS,
        })
    return _BUILDERS


def builder_from_spec(spec: Dict[str, Any]) -> StrategyBuilder:
    """A builder from its cacheable ``{"name", "kwargs"}`` spec."""
    reg = _builder_registry()
    name = spec.get("name")
    if name not in reg:
        raise ValueError(f"unknown builder {name!r} in plan spec (known: {sorted(reg)}); "
                         f"the plan cache may predate this package version")
    return reg[name](**(spec.get("kwargs") or {}))


@dataclasses.dataclass
class Candidate:
    """One point of the joint strategy x knob space."""

    builder_spec: Dict[str, Any]          # {"name": ..., "kwargs": {...}}
    unroll: int = 1
    accumulation_steps: int = 1
    zero: int = 0
    overlap: bool = True                  # the async client's prefetch knob
    prefetch_depth: int = 0               # the input pipeline's depth
    wire_dtype: str = ""                  # quantized push ("" = exact)
    asynchronous: bool = False            # async regime: predicted, never probed
    why: str = ""                         # why it was enumerated
    predicted: Optional[Dict[str, Any]] = None   # costmodel.predict's output
    pruned: Optional[str] = None          # why it was dropped; None = survivor
    probe: Optional[CandidateResult] = None      # the stage-2 measurement
    # Analytic per-device resident bytes (params + optimizer state + the
    # accumulation buffer): the memory pre-flight's basis.
    resident_bytes: Optional[int] = None

    @property
    def name(self) -> str:
        knobs = []
        if self.unroll != 1:
            knobs.append(f"unroll={self.unroll}")
        if self.accumulation_steps != 1:
            knobs.append(f"accum={self.accumulation_steps}")
        if self.zero:
            knobs.append(f"zero={self.zero}")
        if self.prefetch_depth:
            knobs.append(f"pf={self.prefetch_depth}")
        if self.wire_dtype:
            knobs.append(f"wire={self.wire_dtype}")
        if self.asynchronous:
            knobs.append("async" + ("" if self.overlap else ",overlap=0"))
        base = self.builder_spec["name"]
        return f"{base}[{','.join(knobs)}]" if knobs else base

    def make_builder(self) -> StrategyBuilder:
        return builder_from_spec(self.builder_spec)

    def base_key(self) -> Tuple:
        """Candidates that differ only in ``unroll``, ``overlap``,
        ``prefetch_depth`` or ``wire_dtype`` share one probed base step."""
        return (self.builder_spec["name"],
                tuple(sorted((self.builder_spec.get("kwargs") or {}).items())),
                self.accumulation_steps, self.zero, self.asynchronous)


@dataclasses.dataclass
class TunedPlan:
    """The autotuner's product: the winning knobs and the evidence.
    ``to_dict``/``from_dict`` round-trip through the plan cache;
    ``candidates`` (a search's only) is the record behind :meth:`explain`."""

    builder_spec: Dict[str, Any]
    unroll: int = 1
    accumulation_steps: int = 1
    zero: int = 0
    overlap: bool = True
    prefetch_depth: int = 0
    wire_dtype: str = ""
    predicted: Optional[Dict[str, Any]] = None
    measured_steps_per_s: Optional[float] = None
    cache_key: str = ""
    from_cache: bool = False
    search_s: float = 0.0
    enumerated: int = 0
    probed: int = 0
    candidates: List[Candidate] = dataclasses.field(default_factory=list)

    def make_builder(self) -> StrategyBuilder:
        return builder_from_spec(self.builder_spec)

    @property
    def name(self) -> str:
        return Candidate(self.builder_spec, unroll=self.unroll,
                         accumulation_steps=self.accumulation_steps, zero=self.zero,
                         overlap=self.overlap, prefetch_depth=self.prefetch_depth,
                         wire_dtype=self.wire_dtype).name

    def knobs_dict(self) -> Dict[str, Any]:
        return {"builder": self.builder_spec, "unroll": self.unroll,
                "accumulation_steps": self.accumulation_steps, "zero": self.zero,
                "overlap": self.overlap, "prefetch_depth": self.prefetch_depth,
                "wire_dtype": self.wire_dtype}

    def to_dict(self) -> Dict[str, Any]:
        """The cache entry: knobs, prediction, measurement, provenance."""
        return {"cache_key": self.cache_key, "knobs": self.knobs_dict(),
                "predicted": self.predicted,
                "measured_steps_per_s": self.measured_steps_per_s,
                "search_s": round(self.search_s, 3), "enumerated": self.enumerated,
                "probed": self.probed, "from_cache": self.from_cache,
                "created": time.strftime("%Y-%m-%dT%H:%M:%S")}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedPlan":
        knobs = d.get("knobs") or {}
        return cls(builder_spec=knobs.get("builder") or {"name": "AllReduce"},
                   unroll=int(knobs.get("unroll") or 1),
                   accumulation_steps=int(knobs.get("accumulation_steps") or 1),
                   zero=int(knobs.get("zero") or 0),
                   overlap=bool(knobs.get("overlap", True)),
                   prefetch_depth=int(knobs.get("prefetch_depth") or 0),
                   wire_dtype=str(knobs.get("wire_dtype") or ""),
                   predicted=d.get("predicted"),
                   measured_steps_per_s=d.get("measured_steps_per_s"),
                   cache_key=d.get("cache_key") or "",
                   search_s=float(d.get("search_s") or 0.0),
                   enumerated=int(d.get("enumerated") or 0),
                   probed=int(d.get("probed") or 0))

    def explain(self) -> str:
        """Why this plan won: one row per enumerated candidate (its predicted
        step time and binding resource; its measured steps/s or why it was
        pruned or skipped), ranked by prediction, the winner marked. A plan
        from the cache explains itself from its stored record."""
        if not self.candidates:
            src = "plan cache" if self.from_cache else "search"
            pred = (f"predicted {self.predicted['step_s'] * 1e3:.3f} ms/step "
                    f"({self.predicted.get('bound')}-bound)" if self.predicted
                    else "no prediction")
            meas = (f"measured {self.measured_steps_per_s:.2f} steps/s"
                    if self.measured_steps_per_s else "unmeasured")
            return f"{self.name}  <- applied from {src} [{self.cache_key}]\n  {pred}; {meas}"
        rows = sorted(self.candidates,
                      key=lambda c: (c.predicted or {}).get("step_s") or float("inf"))
        width = max(len(c.name) for c in rows)
        lines = [f"autotune [{self.cache_key}]: {self.enumerated} candidates, "
                 f"{self.probed} probed, {self.search_s:.2f}s search"]
        for c in rows:
            pred = c.predicted or {}
            p = (f"{pred['step_s'] * 1e3:9.3f} ms/step {pred['bound']:>7}"
                 if pred.get("step_s") is not None else f"{'?':>9} ms/step {'?':>7}")
            if c.probe is not None and c.probe.steps_per_sec is not None:
                tail = f"measured {c.probe.steps_per_sec:8.2f} steps/s"
                if (c.builder_spec == self.builder_spec and c.unroll == self.unroll
                        and c.accumulation_steps == self.accumulation_steps
                        and c.zero == self.zero
                        and c.prefetch_depth == self.prefetch_depth
                        and c.wire_dtype == self.wire_dtype):
                    tail += "  <- winner"
            elif c.probe is not None:
                tail = f"probe: {c.probe.error}"
            elif c.pruned:
                tail = f"pruned: {c.pruned}"
            else:
                tail = "not probed"
            lines.append(f"  {c.name:<{width}}  {p}  {tail}")
        return "\n".join(lines)


# ------------------------------------------------------------------ cache key

def plan_cache_key(model_spec, example_batch: Any = None,
                   resource_spec: Optional[ResourceSpec] = None) -> str:
    """The cache identity of one tuning problem (``autotune.py:337-373``):
    the trainable parameters' names, shapes, dtypes and sparsity, the
    batch's leaf shapes and dtypes, the device (the card's name and the
    visible count, or the CPU, and the process count), the resource spec's
    node count, and the package: the port's name, its version and torch's.
    A change to any of them misses; a JAX package's key never matches."""
    import torch.distributed as dist

    from autodist_tpu_torch.runner import _leaves
    from autodist_tpu_torch.version import __version__
    parts: List[str] = [f"autodist_tpu_torch-v{__version__}", f"torch-{torch.__version__}"]
    if torch.cuda.is_available():
        parts.append(f"cuda:{torch.cuda.get_device_name(0)}:d{torch.cuda.device_count()}")
    else:
        parts.append("cpu")
    parts.append(f"p{dist.get_world_size() if dist.is_initialized() else 1}")
    if resource_spec is not None:
        parts.append(f"nodes{resource_spec.num_nodes}")
    for name, p in sorted(model_spec.trainable.items()):
        parts.append(f"{name}:{tuple(p.shape)}:{p.dtype}:{'s' if p.sparse else 'd'}")
    if example_batch is not None:
        for leaf in _leaves(example_batch):
            leaf = getattr(leaf, "value", leaf)      # a micro-batched leaf's array
            arr = leaf if hasattr(leaf, "shape") else np.asarray(leaf)
            parts.append(f"b{tuple(arr.shape)}:{arr.dtype}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def _read_cache_file(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if doc.get("schema") != PLAN_SCHEMA or doc.get("schema_version") != PLAN_SCHEMA_VERSION:
        _log.warning("plan cache %s has schema %r v%r (want %s v%d); ignoring it", path,
                     doc.get("schema"), doc.get("schema_version"), PLAN_SCHEMA,
                     PLAN_SCHEMA_VERSION)
        return {}
    return doc if isinstance(doc.get("plans"), dict) else {}


def load_cached_plan(path: str, key: str) -> Optional[TunedPlan]:
    """The cached :class:`TunedPlan` for ``key``, or None: a missing file, a
    wrong schema, an unknown key, or an entry naming a builder this package
    cannot build are misses, never errors."""
    if not path:
        return None
    entry = _read_cache_file(path).get("plans", {}).get(key)
    if not entry:
        return None
    plan = TunedPlan.from_dict(entry)
    plan.cache_key = key
    plan.from_cache = True
    try:
        plan.make_builder()
    except ValueError as e:
        _log.warning("plan cache %s[%s]: %s; treating as a miss", path, key, e)
        return None
    return plan


def store_plan(path: str, plan: TunedPlan) -> bool:
    """Persist ``plan`` under its key (read, modify, write under an ``flock``
    on a sidecar lock file, renamed into place); False after a failed write,
    which is logged and never raised."""
    if not path:
        return False
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(f"{path}.lock", "a") as lock:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass
            doc = _read_cache_file(path) or {"schema": PLAN_SCHEMA,
                                             "schema_version": PLAN_SCHEMA_VERSION,
                                             "plans": {}}
            doc["plans"][plan.cache_key] = plan.to_dict()
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        return True
    except OSError as e:
        _log.warning("plan cache write to %s failed: %s", path, e)
        return False


# ---------------------------------------------------------------- enumeration

def enumerate_candidates(model_spec, resource_spec: ResourceSpec,
                         optimizer: Optional[Callable] = None, *,
                         unrolls: Sequence[int] = DEFAULT_UNROLLS,
                         accums: Sequence[int] = (1,),
                         include_async: Optional[bool] = None,
                         budget: Optional[int] = None,
                         prefetch_depths: Optional[Sequence[int]] = None,
                         loader_s_per_step: float = 0.0,
                         wire_dtypes: Optional[Sequence[str]] = None) -> List[Candidate]:
    """The joint candidate space from :class:`AutoStrategy`'s rules
    (``autotune.py:423-565``): AllReduce and sync PSLoadBalancing always;
    Parallax with sparse parameters; PartitionedAR (and, memory-bound,
    PartitionedPS) with a dense parameter above the partition threshold on
    more than one device; the async PS under memory pressure (predicted,
    never probed). Each crosses ``unroll`` (sync only),
    ``accumulation_steps``, ``zero`` (more than one device) and
    ``prefetch_depth`` (with a loader cost). Deterministic order, capped at
    ``budget`` (``AUTODIST_TUNE_BUDGET``) with a log line; candidates whose
    resident state alone exceeds the device budget are pruned here."""
    from autodist_tpu_torch.strategy.auto_strategy import (_device_memory_budget,
                                                           _fmt_bytes, _opt_state_bytes)
    from autodist_tpu_torch.strategy.partition_utils import partitionable_axis

    if budget is None:
        budget = const.env_int(const.AUTODIST_TUNE_BUDGET, const.TUNE_BUDGET_DEFAULT)
    n_dev = num_devices(resource_spec)
    dense = {n: s for n, s in model_spec.trainable.items() if not s.sparse}
    has_sparse = len(dense) != len(model_spec.trainable)
    dense_bytes = sum(s.byte_size for s in dense.values())
    opt_bytes = _opt_state_bytes(optimizer, model_spec, dense) \
        if optimizer is not None else None
    state_bytes = (dense_bytes + opt_bytes) if opt_bytes is not None else 3 * dense_bytes
    budget_bytes = _device_memory_budget()
    memory_bound = state_bytes > budget_bytes
    partitioned = [s for s in dense.values()
                   if s.byte_size >= 64 << 20 and partitionable_axis(s) is not None]
    if include_async is None:
        include_async = memory_bound

    bases: List[Tuple[Dict[str, Any], bool, str]] = [
        ({"name": "AllReduce"}, False, "dense collective baseline"),
        ({"name": "PSLoadBalancing"}, False, "sync PS (the session default)"),
    ]
    if has_sparse:
        bases.append(({"name": "Parallax"}, False, "sparse params ride the sparse wire"))
    if partitioned and n_dev > 1:
        bases.append(({"name": "PartitionedAR"}, False,
                      f"{len(partitioned)} param(s) above the partition threshold"))
        if memory_bound:
            bases.append(({"name": "PartitionedPS"}, False, "partitioned + memory-bound"))
    if include_async:
        why = ("resident state exceeds the per-device budget" if memory_bound
               else "async regime requested")
        bases.append(({"name": "PS", "kwargs": {"sync": False}}, True, why))

    zeros = [0, 1] if n_dev > 1 else [0]
    if prefetch_depths is None:
        prefetch_depths = DEFAULT_PREFETCH_DEPTHS if loader_s_per_step > 0 else (0,)
    if wire_dtypes is None:
        wire_dtypes = DEFAULT_WIRE_DTYPES
    out: List[Candidate] = []
    for spec, is_async, why in bases:
        for accum in accums:
            for zero in zeros:
                if is_async:
                    if zero:
                        continue
                    for overlap in (True, False):
                        for wire_dtype in wire_dtypes:
                            out.append(Candidate(spec, unroll=1, accumulation_steps=accum,
                                                 zero=0, overlap=overlap,
                                                 wire_dtype=wire_dtype, asynchronous=True,
                                                 why=why))
                    continue
                for unroll in unrolls:
                    for depth in prefetch_depths:
                        out.append(Candidate(spec, unroll=int(unroll),
                                             accumulation_steps=accum, zero=zero,
                                             prefetch_depth=int(depth), why=why))
    if len(out) > budget:
        _log.warning("autotune: enumerated %d candidates, keeping the first %d "
                     "(AUTODIST_TUNE_BUDGET); raise the budget to rank the rest",
                     len(out), budget)
        out = out[:budget]
    part_bytes = sum(s.byte_size for s in partitioned)
    for c in out:
        d_bytes = dense_bytes
        if c.builder_spec["name"].startswith("Partitioned") and n_dev > 1:
            d_bytes = dense_bytes - part_bytes + part_bytes // n_dev
        c.resident_bytes = _predicted_resident_bytes(c, d_bytes, opt_bytes, n_dev)
        if c.resident_bytes > budget_bytes:
            c.pruned = (f"oom: predicted resident {_fmt_bytes(c.resident_bytes)} exceeds "
                        f"the per-device budget {_fmt_bytes(budget_bytes)} — refused "
                        f"before the compile probe")
    return out


def _predicted_resident_bytes(cand: Candidate, dense_bytes: int, opt_bytes: Optional[int],
                              n_dev: int) -> int:
    """Params, the optimizer state the knobs leave on the device (ZeRO
    shards it; the async regime moves it to the servers) and one gradient
    buffer when accumulating."""
    opt_eff = opt_bytes if opt_bytes is not None else 2 * dense_bytes
    if cand.asynchronous:
        return int(2 * dense_bytes)
    if cand.zero:
        opt_eff = opt_eff // max(1, n_dev)
    resident = dense_bytes + opt_eff
    if cand.accumulation_steps > 1:
        resident += dense_bytes
    return int(resident)


# ------------------------------------------------------------------ stage 1

def _load_calibration(calibration: Optional[costmodel.Calibration]
                      ) -> Tuple[costmodel.Calibration, str]:
    """An explicit calibration, else the newest ``AUTODIST_PROFILE_DIR``
    profile's, else the bundled one. A profile whose fitted rates exceed the
    card's peaks (:func:`_unphysical`) is skipped with a warning."""
    if calibration is not None:
        return calibration, "explicit"
    prof_dir = const.ENV.AUTODIST_PROFILE_DIR.val
    if prof_dir and os.path.isdir(prof_dir):
        def mtime(path):
            try:
                return os.path.getmtime(path)
            except OSError:
                return 0.0

        profiles = sorted((os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
                           if f.startswith("profile-") and f.endswith(".json")), key=mtime)
        for path in reversed(profiles):
            try:
                with open(path) as f:
                    doc = json.load(f)
                calib = costmodel.calibrate(doc)
                if not (calib.flops_per_s or calib.host_s_per_dispatch):
                    continue
                why = _unphysical(calib, doc)
                if why:
                    _log.warning("autotune: skipping profile %s: %s", path, why)
                    continue
                return calib, f"profile:{os.path.basename(path)}"
            except (OSError, ValueError, TypeError):
                continue
    return DEFAULT_CALIBRATION, "bundled-default"


def _unphysical(calib: costmodel.Calibration, doc: Dict[str, Any]) -> str:
    """Why ``calib`` cannot be a rate this card sustained ("" when it can):
    a fitted FLOP/s or bytes/s above the peak of ``telemetry.peak_spec()``,
    or of the profile's own ``peaks`` where this process knows none. Such a
    fit comes from a profile whose compute share is too small, e.g. when the
    launch queue is full and the enqueue's wait is booked as host time."""
    spec = telemetry.peak_spec()
    own = doc.get("peaks") or {}
    for name, fitted, peak in (
            ("FLOP/s", calib.flops_per_s, spec.flops_per_s or own.get("flops_per_s")),
            ("bytes/s", calib.bytes_per_s,
             spec.membw_bytes_per_s or own.get("membw_bytes_per_s"))):
        if fitted and peak and fitted > peak:
            return f"fitted {name} {fitted:.4g} exceeds the peak {peak:.4g}"
    return ""


def _wire_terms(model_spec, cand: Candidate) -> Tuple[float, float]:
    """``(comm_bytes, quantize_bytes)`` a step of an async candidate charges:
    the push scaled by its wire dtype, the pull unless the client overlaps
    it, and the dense bytes quantized. Sync candidates cross no host wire."""
    if not cand.asynchronous:
        return 0.0, 0.0
    dense_bytes = float(sum(s.byte_size for s in model_spec.trainable.values()
                            if not s.sparse))
    push = dense_bytes * _WIRE_RATIO.get(cand.wire_dtype, 1.0)
    pull = 0.0 if cand.overlap else dense_bytes
    quantize = dense_bytes if cand.wire_dtype else 0.0
    return push + pull, quantize


def _derive_record(base: Dict[str, Any], unroll: int) -> Dict[str, Any]:
    """A candidate's cost record from its base (one-step) probe. ``unroll=1``
    is the eager step itself, one launch a kernel. ``unroll=K`` is one CUDA
    graph replay doing K steps' work: FLOPs and bytes scale by K, the
    launches are 1 (the JAX package's ``_derive_record``, with the port's
    ``launches``)."""
    if unroll == 1:
        return dict(base)
    return {"flops": (base.get("flops") or 0.0) * unroll or None,
            "bytes_accessed": (base.get("bytes_accessed") or 0.0) * unroll or None,
            "steps": unroll * max(1, int(base.get("steps") or 1)),
            "dispatches": 1, "launches": 1}


def _probe_base_costs(cands: List[Candidate], loss_fn, params, optimizer, example_batch,
                      resource_spec, sparse_names, has_aux, device=None):
    """One ``plan_costs`` probe per distinct base step (builder x accum x
    zero); async bases borrow the sync PS probe's costs. Returns
    ``{base_key: record}``, a failed probe an error string instead
    (``autotune.py:662-726``)."""
    from autodist_tpu_torch.autodist import AutoDist

    base_costs: Dict[Tuple, Any] = {}
    sync_ps_cost = None
    for cand in cands:
        if cand.pruned:
            continue
        key = cand.base_key()
        if key in base_costs:
            continue
        if cand.asynchronous:
            base_costs[key] = None
            continue
        ad = runner = None
        try:
            with telemetry.span("tune.compile_probe", candidate=cand.name):
                ad = AutoDist(resource_spec, cand.make_builder(), device=device)
                runner = ad.create_distributed_session(
                    loss_fn, params, optimizer, example_batch=example_batch,
                    sparse_names=sparse_names, has_aux=has_aux,
                    accumulation_steps=cand.accumulation_steps, zero=cand.zero, tune=False)
                cost = runner.plan_costs(params, example_batch, unroll=1)
            base_costs[key] = cost if cost is not None else \
                "probe: the step did not trace (no cost)"
            if cand.builder_spec["name"] == "PSLoadBalancing" and isinstance(cost, dict):
                sync_ps_cost = cost
        except Exception as e:  # noqa: BLE001 — a candidate failing to build must not abort
            base_costs[key] = f"{type(e).__name__}: {e}"
            _log.warning("autotune cost probe %s failed: %s", cand.name, e)
        finally:
            ad = runner = None  # noqa: F841
            gc.collect()
    for key, val in base_costs.items():
        if val is None:
            base_costs[key] = sync_ps_cost if sync_ps_cost is not None else \
                "probe: no sync PS base to approximate the async program from"
    return base_costs


# ------------------------------------------------------------------- search

def autotune(loss_fn: Callable, params: Any, optimizer: Callable, example_batch: Any, *,
             resource_spec: Optional[ResourceSpec] = None,
             sparse_names: Optional[Sequence[str]] = None,
             has_aux: bool = False,
             unrolls: Sequence[int] = DEFAULT_UNROLLS,
             accumulation_steps: Sequence[int] = (1,),
             top_k: Optional[int] = None,
             budget: Optional[int] = None,
             margin: float = PRUNE_MARGIN,
             calibration: Optional[costmodel.Calibration] = None,
             plan_cache: Optional[str] = None,
             warmup_steps: int = 2, measure_steps: int = 8,
             include_async: Optional[bool] = None,
             prefetch_depths: Optional[Sequence[int]] = None,
             loader_s_per_step: float = 0.0,
             device=None) -> TunedPlan:
    """The two-stage plan search; returns the winning :class:`TunedPlan`
    (``autotune.py:729-922``).

    A warm ``plan_cache`` entry (``AUTODIST_PLAN_CACHE`` when None) for this
    (model, batch, device, package) returns at once: no probe, no measured
    step. Otherwise stage 1 probes one base step per (builder, accum, zero)
    with ``plan_costs``, derives the unroll grid, ranks everything with the
    calibrated cost model and prunes; stage 2 measures at most ``top_k``
    (``AUTODIST_TUNE_TOPK``) survivors with ``measure_steps`` real steps
    each. The measured winner is stored and returned. ``loader_s_per_step``
    declares the input pipeline's host seconds a step, which also ranks
    ``prefetch_depth``. Raises ``RuntimeError`` when no stage-2 probe
    succeeds. ``device`` is the sessions' (default: the card)."""
    from autodist_tpu_torch.model_spec import ModelSpec

    t_start = time.perf_counter()
    if plan_cache is None:
        plan_cache = const.env_str(const.AUTODIST_PLAN_CACHE)
    if top_k is None:
        top_k = const.env_int(const.AUTODIST_TUNE_TOPK, const.TUNE_TOPK_DEFAULT)
    if top_k < 1:
        raise ValueError("top_k must be >= 1 (stage 2 needs at least one measured "
                         "candidate)")
    resource_spec = resource_spec if resource_spec is not None else ResourceSpec(None)
    if resource_spec.num_nodes > 1:
        raise ValueError("autotune probes candidates on THIS process's local devices; a "
                         "multi-node resource spec would be ranked by a measurement that "
                         "ignores the cross-node wire (same contract as tune_strategy)")
    model_spec = (ModelSpec(params, sparse_names=sparse_names) if sparse_names is not None
                  else ModelSpec.from_loss_fn(loss_fn, params, example_batch))
    key = plan_cache_key(model_spec, example_batch, resource_spec)

    cached = load_cached_plan(plan_cache, key)
    if cached is not None:
        telemetry.counter("tune.cache_hit").inc()
        _log.info("autotune: plan cache hit [%s] -> %s (predicted %s, measured %s steps/s); "
                  "no probe steps", key, cached.name, (cached.predicted or {}).get("step_s"),
                  cached.measured_steps_per_s)
        return cached

    telemetry.counter("tune.cache_miss").inc()
    with telemetry.span("tune.search", key=key):
        # Stage 1: enumerate, probe the bases' costs, predict, prune.
        cands = enumerate_candidates(
            model_spec, resource_spec, optimizer, unrolls=unrolls,
            accums=tuple(accumulation_steps), include_async=include_async, budget=budget,
            prefetch_depths=prefetch_depths, loader_s_per_step=loader_s_per_step)
        calib, calib_src = _load_calibration(calibration)
        _log.info("autotune [%s]: %d candidates, calibration %s", key, len(cands), calib_src)
        with telemetry.span("tune.predict", candidates=len(cands)):
            base_costs = _probe_base_costs(cands, loss_fn, params, optimizer, example_batch,
                                           resource_spec, sparse_names, has_aux, device)
            for c in cands:
                if c.pruned:
                    continue
                base = base_costs.get(c.base_key())
                if not isinstance(base, dict):
                    c.pruned = str(base)
                    continue
                comm_bytes, quantize_bytes = _wire_terms(model_spec, c)
                c.predicted = costmodel.predict(
                    _derive_record(base, c.unroll), calib, comm_bytes_per_step=comm_bytes,
                    loader_s_per_step=loader_s_per_step, prefetch_depth=c.prefetch_depth,
                    quantize_bytes_per_step=quantize_bytes,
                    resident_bytes=float(c.resident_bytes or 0))
        predicted = [c for c in cands if c.predicted is not None]
        if not predicted:
            raise RuntimeError("autotune: no candidate could be cost-probed:\n"
                               + "\n".join(f"  {c.name}: {c.pruned}" for c in cands))
        best_pred = min(c.predicted["step_s"] for c in predicted)
        survivors: List[Candidate] = []
        # prefetch_depth changes the host pipeline, not the step: a depth twin of
        # a survivor shares its measurement instead of a top-k slot.
        probe_sharers: List[Tuple[Candidate, Candidate]] = []
        probed_programs: Dict[Tuple, Candidate] = {}
        for c in sorted(predicted, key=lambda c: c.predicted["step_s"]):
            if c.asynchronous:
                c.pruned = ("skipped: async candidate — predicted only, not measurable by the "
                            "synchronous probe loop")
            elif c.predicted["step_s"] > (1.0 + margin) * best_pred:
                c.pruned = (f"predicted {c.predicted['step_s'] * 1e3:.3f} ms/step, > "
                            f"{1.0 + margin:.2f}x the frontrunner ({best_pred * 1e3:.3f} ms)")
            else:
                program = (c.base_key(), c.unroll, c.overlap)
                twin = probed_programs.get(program)
                if twin is not None:
                    probe_sharers.append((c, twin))
                elif len(survivors) >= top_k:
                    c.pruned = f"beyond top-k={top_k}"
                else:
                    survivors.append(c)
                    probed_programs[program] = c

        # The gauges reconcile: candidates = pruned + survivors + sharers.
        telemetry.gauge("tune.candidates").set(len(cands))
        telemetry.gauge("tune.pruned").set(len(cands) - len(survivors) - len(probe_sharers))
        telemetry.gauge("tune.pruned_oom").set(
            sum(1 for c in cands if (c.pruned or "").startswith("oom")))

        # Stage 2: measure the survivors with real steps.
        for c in survivors:
            with telemetry.span("tune.probe", candidate=c.name):
                c.probe = measure_candidate(
                    c.make_builder(), loss_fn, params, optimizer, example_batch,
                    name=c.name, resource_spec=resource_spec, warmup_steps=warmup_steps,
                    measure_steps=measure_steps, sparse_names=sparse_names,
                    has_aux=has_aux, accumulation_steps=c.accumulation_steps,
                    unroll=c.unroll, zero=c.zero, device=device)
        telemetry.gauge("tune.probed").set(len(survivors))
        for c, twin in probe_sharers:
            c.probe = twin.probe
        measured = [c for c in survivors + [s for s, _ in probe_sharers]
                    if c.probe is not None and c.probe.steps_per_sec is not None]
        if not measured:
            raise RuntimeError("autotune: every stage-2 probe failed or was skipped:\n"
                               + "\n".join(f"  {c.name}: {c.probe.error}" for c in survivors))

        def effective_steps_per_s(c: Candidate) -> float:
            # The probe feeds a resident batch: a declared loader cost comes
            # back as the candidate's priced residual data wait.
            sps = c.probe.steps_per_sec
            data_s = ((c.predicted or {}).get("breakdown") or {}).get("data_wait_s") or 0.0
            return 1.0 / (1.0 / sps + data_s) if data_s > 0 else sps

        winner = max(measured, key=effective_steps_per_s)
    plan = TunedPlan(
        builder_spec=winner.builder_spec, unroll=winner.unroll,
        accumulation_steps=winner.accumulation_steps, zero=winner.zero,
        overlap=winner.overlap, prefetch_depth=winner.prefetch_depth,
        wire_dtype=winner.wire_dtype, predicted=winner.predicted,
        measured_steps_per_s=winner.probe.steps_per_sec, cache_key=key,
        search_s=time.perf_counter() - t_start, enumerated=len(cands),
        probed=len(survivors), candidates=cands)
    telemetry.gauge("tune.best_steps_per_s").set(plan.measured_steps_per_s)
    telemetry.gauge("tune.search_s").set(plan.search_s)
    if plan_cache:
        store_plan(plan_cache, plan)
    _log.info("autotune winner [%s]: %s (%.2f steps/s measured, %.2f ms predicted, %d/%d "
              "probed, %.2fs search)", key, plan.name, plan.measured_steps_per_s,
              (plan.predicted or {}).get("step_s", 0.0) * 1e3, plan.probed, plan.enumerated,
              plan.search_s)
    return plan
