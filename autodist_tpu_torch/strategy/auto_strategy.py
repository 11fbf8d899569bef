"""AutoStrategy: analytic selection of a per-parameter strategy (the port's
copy of ``autodist_tpu/strategy/auto_strategy.py:52-391``).

It reads what every builder gets (parameter bytes, shapes and sparse flags;
the resource spec's device and node counts and ``network_bandwidth``) and
derives the per-parameter choice the fixed builders leave to the user:

1. **Regime.** When resident train state (the dense parameters plus the
   optimizer's state bytes) exceeds the per-device memory budget, dense
   parameters take the PS/ZeRO regime (state sharded along ``reduce``);
   otherwise plain AllReduce. ``create_distributed_session`` hands the
   builder its optimizer factory (:meth:`AutoStrategy.observe_optimizer`).
   The JAX package reads exact state bytes from ``jax.eval_shape``; the port
   builds the optimizer over meta tensors of the parameters' shapes and
   lets it create its state, allocating nothing. An optimizer that cannot
   do that (or none) gets the Adam-class 3x assumption, and ``explain()``
   says so.
2. **Sparse.** Embedding-style parameters go to load-balanced PS, so their
   gradients ride the sparse wire (the Parallax rule).
3. **Partitioning.** A dense parameter above ``partition_threshold_bytes``
   with a partitionable axis is sharded over a ``model`` axis.
4. **Wire codec.** On multi-node specs AllReduce becomes DCN (the
   hierarchical reduce) and, below ``bf16_bandwidth_gbps`` /
   ``ef_bandwidth_gbps`` on the slowest stated link, bf16 / bf16 with
   error feedback.

Every decision is logged; ``explain()`` returns the table of the last
``build()``.
"""

import logging
from typing import Callable, Dict, Optional

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec, ParamSpec
from autodist_tpu_torch.proto.strategy import (AllReduceSynchronizer, NodeConfig,
                                               PartitionConfig, PSSynchronizer)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import parse_ar_options
from autodist_tpu_torch.strategy.base import (AR_DEFAULT_AXES, PS_DEFAULT_AXES, Strategy,
                                              StrategyBuilder, num_devices)
from autodist_tpu_torch.strategy.partition_utils import make_num_shards, partitionable_axis
from autodist_tpu_torch.strategy.ps_lb_strategy import byte_size_load_fn

_log = logging.getLogger("autodist_tpu_torch")

_ADAM_STATE_MULTIPLIER = 3          # params + two moments: the no-optimizer assumption

_AR = AllReduceSynchronizer


def _device_memory_budget() -> int:
    """Usable per-device memory through the memory plane
    (:func:`autodist_tpu_torch.telemetry.memplane.device_budget`, the one
    budget the plane and the autotuner's pre-flight share): 80% of the
    card's memory, else the ``AUTODIST_MEM_BUDGET`` override in bytes, else
    a warned 8 GiB default, its source booked as ``mem.budget_source``."""
    from autodist_tpu_torch.telemetry import memplane
    budget, _source = memplane.device_budget()
    return budget


def _fmt_bytes(n: int) -> str:
    """Human units that never round a nonzero count to zero (three
    significant digits, fixed point)."""
    value, unit = float(n), "B"
    for next_unit in ("KiB", "MiB", "GiB", "TiB"):
        if value < 1024:
            break
        value, unit = value / 1024, next_unit
    if unit == "B":
        return f"{int(value)} B"
    if value >= 100:
        return f"{value:.0f} {unit}"
    if value >= 10:
        return f"{value:.1f} {unit}"
    return f"{value:.2f} {unit}"


def _state_bytes(optimizer: Callable, shapes: Dict[str, tuple]) -> Optional[Dict[str, int]]:
    """The optimizer state bytes of each parameter, by name, with no memory
    allocated: ``optimizer`` (a factory, ``optimizer(list_of_params)``) is
    built over meta tensors of ``shapes`` (``{name: (shape, dtype)}``) and
    stepped once on meta gradients, which creates its state (an optimizer
    whose update reads values back to the host fails after that, which is
    enough). Step counters are not counted. None when the factory does not
    build there or leaves a parameter without state."""
    metas = {n: torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)
             for n, (shape, dtype) in shapes.items()}
    try:
        opt = optimizer(list(metas.values()))
        for p in metas.values():
            p.grad = torch.empty_like(p)
        try:
            opt.step()
        except Exception as e:  # noqa: BLE001 — the state exists before the update
            _log.debug("optimizer step on meta tensors stopped: %s", e)
    except Exception as e:  # noqa: BLE001 — any factory may refuse meta tensors
        _log.warning("AutoStrategy: could not build the optimizer over meta tensors (%s); "
                     "falling back to the Adam-class 3x assumption", e)
        return None
    out = {}
    for name, p in metas.items():
        state = opt.state.get(p)
        if not state:
            _log.warning("AutoStrategy: %s created no state for %s on meta tensors; "
                         "falling back to the Adam-class 3x assumption",
                         type(opt).__name__, name)
            return None
        out[name] = sum(v.numel() * v.element_size() for k, v in state.items()
                        if isinstance(v, torch.Tensor) and k != "step")
    return out


def _opt_state_bytes(optimizer: Callable, model_spec: ModelSpec, dense_names) -> Optional[int]:
    """The optimizer state bytes of the dense parameters (``_opt_state_bytes``
    in the JAX package, from meta tensors here), or None when the optimizer
    cannot say (see :func:`_state_bytes`)."""
    shapes = {n: (tuple(s.shape), s.dtype) for n, s in model_spec.trainable.items()}
    per_param = _state_bytes(optimizer, shapes)
    if per_param is None:
        return None
    return sum(per_param[n] for n in dense_names)


class OptimizerChoice:
    """Result of :func:`choose_optimizer`: the optimizer factory and the
    decision."""

    def __init__(self, optimizer: Callable, factored: bool, reason: str):
        self.optimizer = optimizer
        self.factored = factored       # True: memory-tight, factored moments
        self.reason = reason

    def __repr__(self):
        return f"OptimizerChoice(factored={self.factored}, {self.reason!r})"


def choose_optimizer(params: Dict[str, torch.Tensor], learning_rate: float = 1e-3,
                     memory_budget_bytes: Optional[int] = None) -> OptimizerChoice:
    """``torch.optim.Adam`` when its moments fit the per-device budget next to
    the params and gradients; ``torch.optim.Adafactor`` (a factored second
    moment) when they do not (``auto_strategy.py:139-173``). Residency:
    params + gradients (about the params' bytes) + Adam's state, with
    Adam's state bytes from meta tensors; activations are left to the
    budget's 20% headroom."""
    budget = memory_budget_bytes if memory_budget_bytes is not None \
        else _device_memory_budget()
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())

    def adam(p):
        return torch.optim.Adam(p, lr=learning_rate)

    state = _state_bytes(adam, {k: (tuple(t.shape), t.dtype) for k, t in params.items()})
    adam_bytes = sum(state.values()) if state is not None else 2 * param_bytes
    resident = 2 * param_bytes + adam_bytes   # params + grads + moments
    if resident <= budget:
        return OptimizerChoice(adam, False, (
            f"adam: params+grads+moments {_fmt_bytes(resident)} "
            f"<= budget {_fmt_bytes(budget)}"))
    return OptimizerChoice(lambda p: torch.optim.Adafactor(p, lr=learning_rate), True, (
        f"adafactor: adam residency {_fmt_bytes(resident)} exceeds budget "
        f"{_fmt_bytes(budget)}; factored second moment fits"))


class AutoStrategy(StrategyBuilder):
    """Pick per-parameter synchronization from an analytic cost model."""

    def __init__(self, memory_budget_bytes: Optional[int] = None,
                 partition_threshold_bytes: int = 64 << 20,
                 bf16_bandwidth_gbps: int = 100, ef_bandwidth_gbps: int = 25,
                 chunk_size: int = 128, optimizer: Optional[Callable] = None):
        """``optimizer``: the session's optimizer factory, pinned (else the
        one ``create_distributed_session`` observes)."""
        self._budget = memory_budget_bytes
        self._partition_threshold = partition_threshold_bytes
        self._bf16_gbps = bf16_bandwidth_gbps
        self._ef_gbps = ef_bandwidth_gbps
        self._chunk_size, _, _ = parse_ar_options(chunk_size, "AUTO", "NoneCompressor")
        self._optimizer = optimizer
        self._optimizer_explicit = optimizer is not None
        self._decisions: list = []

    def observe_optimizer(self, optimizer: Callable) -> None:
        """Called by ``create_distributed_session`` with the session's
        optimizer factory, so the memory rule uses its state bytes; one
        passed to the constructor wins."""
        if not self._optimizer_explicit:
            self._optimizer = optimizer

    def _pick_codec(self, resource_spec: ResourceSpec):
        """(spec, compressor, reason) for AllReduce nodes, from the slowest
        stated link. Lossy codecs are chosen only from bandwidth the user
        stated: a spec without ``network_bandwidth`` keeps the lossless
        wire."""
        if resource_spec.num_nodes <= 1:
            return _AR.Spec.AUTO, _AR.Compressor.NONE, \
                "single node: one card's links, uncompressed wire"
        if not all(n.bandwidth_specified for n in resource_spec.nodes):
            _log.warning("AutoStrategy: multi-node spec without explicit network_bandwidth; "
                         "keeping the lossless wire (set network_bandwidth per node to "
                         "enable bf16/error-feedback compression)")
            return _AR.Spec.DCN, _AR.Compressor.NONE, (
                "multi-node, bandwidth unspecified: hierarchical DCN reduce, "
                "lossless wire (declare network_bandwidth to opt into bf16/EF)")
        slowest = min(n.network_bandwidth for n in resource_spec.nodes)
        if slowest <= self._ef_gbps:
            return _AR.Spec.DCN, _AR.Compressor.BF16_EF, (
                f"multi-node, slowest link {slowest} Gbps <= {self._ef_gbps}: "
                f"hierarchical DCN reduce + bf16 with error feedback")
        if slowest <= self._bf16_gbps:
            return _AR.Spec.DCN, _AR.Compressor.BF16, (
                f"multi-node, slowest link {slowest} Gbps <= {self._bf16_gbps}: "
                f"hierarchical DCN reduce + bf16 wire")
        return _AR.Spec.DCN, _AR.Compressor.NONE, (
            f"multi-node, slowest link {slowest} Gbps: hierarchical DCN reduce")

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        self._decisions = []
        n_dev = num_devices(resource_spec)
        budget = self._budget if self._budget is not None else _device_memory_budget()
        dense = {n: s for n, s in model_spec.trainable.items() if not s.sparse}
        dense_bytes = sum(s.byte_size for s in dense.values())
        opt_bytes = None
        if self._optimizer is not None:
            opt_bytes = _opt_state_bytes(self._optimizer, model_spec, dense)
        if opt_bytes is not None:
            state_bytes = dense_bytes + opt_bytes
            state_how = (f"params {_fmt_bytes(dense_bytes)} + optimizer state "
                         f"{_fmt_bytes(opt_bytes)} (built on meta tensors)")
        else:
            state_bytes = _ADAM_STATE_MULTIPLIER * dense_bytes
            why = ("the optimizer does not build its state on meta tensors"
                   if self._optimizer is not None
                   else "pass the optimizer for its state bytes")
            state_how = (f"{_ADAM_STATE_MULTIPLIER}x params {_fmt_bytes(dense_bytes)} "
                         f"(Adam-class assumption; {why})")
        memory_bound = state_bytes > budget
        if (memory_bound and opt_bytes is not None and opt_bytes >= 1.5 * dense_bytes
                and dense_bytes + int(0.1 * dense_bytes) <= budget):
            self._decisions.append((
                "<recommend>",
                f"optimizer state {_fmt_bytes(opt_bytes)} dominates the memory pressure "
                f"(params only {_fmt_bytes(dense_bytes)}): a factored-moment optimizer "
                f"(torch.optim.Adafactor / strategy.choose_optimizer) would fit the "
                f"{_fmt_bytes(budget)} budget without the PS/ZeRO regime"))

        # A `model` axis for physical tensor sharding: large enough that the
        # biggest partitioned parameter's shard drops below the threshold, a
        # divisor of the device count.
        partitioned = [s for s in model_spec.trainable.values()
                       if not s.sparse and s.byte_size >= self._partition_threshold
                       and partitionable_axis(s) is not None]
        model_axis = 1
        if partitioned and n_dev > 1:
            need = max(-(-s.byte_size // self._partition_threshold) for s in partitioned)
            divisors = [d for d in range(2, n_dev + 1) if n_dev % d == 0]
            model_axis = next((d for d in divisors if d >= need),
                              divisors[-1] if divisors else 1)

        ar_spec, ar_compressor, codec_reason = self._pick_codec(resource_spec)
        axes = dict(PS_DEFAULT_AXES if memory_bound else AR_DEFAULT_AXES)
        if not memory_bound and ar_spec == _AR.Spec.DCN:
            # The two-phase reduce needs both data axes populated: the inner
            # one from the per-node card count.
            counts = [max(1, len(n.accelerator_devices)) for n in resource_spec.nodes]
            inner = counts[0] if len(set(counts)) == 1 else 0
            if model_axis > 1:
                _log.warning("AutoStrategy: hierarchical DCN reduce downgraded: partitioned "
                             "parameters use the implicit lowering")
            elif inner > 1 and n_dev % inner == 0:
                axes = {const.MESH_AXIS_REDUCE: inner, const.MESH_AXIS_DATA: -1}
                self._decisions.append(
                    ("<mesh>", f"DCN hierarchical reduce: inner axis = {inner} "
                               f"cards/node x {n_dev // inner} nodes"))
            else:
                _log.warning("AutoStrategy: hierarchical DCN reduce downgraded to a "
                             "single-phase reduce: per-node card counts %s do not form an "
                             "even inner mesh axis", counts)
        if model_axis > 1:
            axes[const.MESH_AXIS_MODEL] = model_axis
        resolved = self._resolved_axes(resource_spec, axes)
        n_dest = resolved.get(const.MESH_AXIS_REDUCE, 1)

        self._decisions.append(
            ("<regime>",
             f"{'PS/ZeRO' if memory_bound else 'AllReduce'}: resident state "
             f"{_fmt_bytes(state_bytes)} ({state_how}) "
             f"{'>' if memory_bound else '<='} budget {_fmt_bytes(budget)} "
             f"on {n_dev} devices"))
        self._decisions.append(("<codec>", codec_reason))

        strategy = Strategy()
        loads = [0] * n_dest
        dense_idx = 0

        def fill_ps(node: NodeConfig, load: int) -> int:
            dest = min(range(n_dest), key=loads.__getitem__)
            loads[dest] += load
            node.ps_synchronizer = PSSynchronizer(reduction_destination=f"reduce:{dest}",
                                                  sync=True)
            return dest

        def fill_ar(node: NodeConfig):
            nonlocal dense_idx
            node.all_reduce_synchronizer = AllReduceSynchronizer(
                spec=ar_spec, compressor=ar_compressor, group=dense_idx // self._chunk_size)
            dense_idx += 1

        for spec in model_spec.trainable.values():
            node = NodeConfig(var_name=spec.name, sparse=spec.sparse)
            strategy.proto.node_config.append(node)
            if spec.sparse:
                dest = fill_ps(node, byte_size_load_fn(spec))
                self._log(spec, f"sparse grads -> PS reduce:{dest} (sparse wire)")
                continue
            axis = partitionable_axis(spec)
            if (model_axis > 1 and axis is not None
                    and spec.byte_size >= self._partition_threshold):
                self._fill_partitioned(node, spec, axis, model_axis, memory_bound,
                                       fill_ps, fill_ar)
                continue
            if memory_bound:
                dest = fill_ps(node, byte_size_load_fn(spec))
                self._log(spec, f"dense -> PS/ZeRO reduce:{dest} (memory-bound)")
            else:
                fill_ar(node)
                self._log(spec, "dense -> AllReduce")

        self._fill_mesh_config(strategy, resource_spec, resolved)
        for name, why in self._decisions:
            _log.info("AutoStrategy %s: %s", name, why)
        return strategy

    def _fill_partitioned(self, node: NodeConfig, spec: ParamSpec, axis: int, k: int,
                          memory_bound: bool, fill_ps, fill_ar):
        node.partitioner = PartitionConfig(num_shards=list(make_num_shards(len(spec.shape),
                                                                           axis, k)),
                                           mesh_axis=const.MESH_AXIS_MODEL)
        for i in range(k):
            part = NodeConfig(var_name=f"{spec.name}/part_{i}", sparse=spec.sparse)
            node.part_config.append(part)
            if memory_bound:
                fill_ps(part, max(byte_size_load_fn(spec) // k, 1))
            else:
                fill_ar(part)
        self._log(spec, f"{_fmt_bytes(spec.byte_size)} >= partition threshold "
                        f"{_fmt_bytes(self._partition_threshold)}: {k} shards on axis "
                        f"{axis} ({'PS' if memory_bound else 'AllReduce'} per shard)")

    def _log(self, spec: ParamSpec, why: str):
        self._decisions.append((spec.name, why))

    def explain(self) -> str:
        """Human-readable decision table for the last ``build()``."""
        if not self._decisions:
            return "AutoStrategy: no build yet"
        width = max(len(n) for n, _ in self._decisions)
        return "\n".join(f"{n:<{width}}  {w}" for n, w in self._decisions)

