"""Expert-parallel strategy: MoE expert weights sharded over the ``expert``
axis (``autodist_tpu/strategy/expert_parallel_strategy.py:26-72``).

Parameters identified as expert-banked (leading dimension equal to
``num_experts`` and a name that passes ``expert_filter``) get a partitioner on
tensor axis 0 mapped onto the ``expert`` mesh axis, so each rank stores only
its experts and computes with them in place (:mod:`autodist_tpu_torch.models.moe`
sums the ranks' partial outputs over the expert group). Every other parameter
falls back to AllReduce data parallelism.
"""

from typing import Callable, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import parse_ar_options
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, num_devices


def _default_expert_filter(name: str) -> bool:
    return "expert" in name.lower()


class ExpertParallel(StrategyBuilder):
    """AllReduce everywhere + expert-axis sharding for expert-banked parameters.

    ``expert_axis_size`` sizes the mesh ``expert`` axis (-1 = the largest
    divisor of both the device count and ``num_experts``); the remaining
    devices fill the ``data`` axis.
    """

    def __init__(self, num_experts: int, expert_axis_size: int = -1,
                 expert_filter: Optional[Callable[[str], bool]] = None,
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        if num_experts < 2:
            raise ValueError("num_experts must be >= 2")
        self._num_experts = num_experts
        self._expert_axis_size = expert_axis_size
        self._expert_filter = expert_filter or _default_expert_filter
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)

    def _resolve_expert_axis(self, resource_spec: ResourceSpec) -> int:
        n = num_devices(resource_spec)
        size = self._expert_axis_size
        if size == -1:
            # Every expert shard holds num_experts/size whole experts.
            size = next(s for s in range(min(n, self._num_experts), 0, -1)
                        if n % s == 0 and self._num_experts % s == 0)
        if n % size != 0:
            raise ValueError(f"expert_axis_size={size} does not divide {n} devices")
        if self._num_experts % size != 0:
            raise ValueError(f"expert_axis_size={size} does not divide num_experts="
                             f"{self._num_experts}")
        return size

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        expert_size = self._resolve_expert_axis(resource_spec)

        def is_expert(spec):
            return (self._expert_filter(spec.name) and len(spec.shape) >= 1
                    and spec.shape[0] == self._num_experts)

        return self._build_axis0_sharded(
            model_spec, resource_spec, const.MESH_AXIS_EXPERT, expert_size,
            is_expert, self._spec, self._compressor, self._chunk_size)
