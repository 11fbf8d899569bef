"""Pipeline-parallel strategy: stacked layer weights sharded over the ``pipe``
axis (``autodist_tpu/strategy/pipeline_strategy.py:25-56``).

Targets models whose block weights are stacked on a leading layer dimension
(:mod:`autodist_tpu_torch.models.pipeline_lm`): those parameters get a
partitioner on tensor axis 0 mapped onto the ``pipe`` mesh axis, so each rank
stores the contiguous group of layers its stage runs, and everything else
(embedding, head, norms) falls back to AllReduce data parallelism. The
schedule itself lives in the model (:mod:`autodist_tpu_torch.parallel.pipeline`);
this builder supplies the matching storage sharding and mesh.
"""

from typing import Callable, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import parse_ar_options
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, num_devices


def _default_stage_filter(name: str) -> bool:
    return "blocks" in name.lower()


class Pipeline(StrategyBuilder):
    """AllReduce everywhere + pipe-axis sharding for layer-stacked parameters.

    ``n_stages`` sizes the mesh ``pipe`` axis (must divide the device count);
    layer-stacked parameters must have a leading dim divisible by ``n_stages``.
    """

    def __init__(self, n_stages: int, stage_filter: Optional[Callable[[str], bool]] = None,
                 chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        if n_stages < 2:
            raise ValueError("n_stages must be >= 2")
        self._n_stages = n_stages
        self._stage_filter = stage_filter or _default_stage_filter
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        n = num_devices(resource_spec)
        if n % self._n_stages != 0:
            raise ValueError(f"n_stages={self._n_stages} does not divide {n} devices")

        def is_stage(spec):
            return (self._stage_filter(spec.name) and len(spec.shape) >= 1
                    and spec.shape[0] % self._n_stages == 0)

        return self._build_axis0_sharded(
            model_spec, resource_spec, const.MESH_AXIS_PIPE, self._n_stages,
            is_stage, self._spec, self._compressor, self._chunk_size)
