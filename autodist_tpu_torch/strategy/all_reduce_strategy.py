"""AllReduce strategy: every parameter synchronized by gradient all-reduce
(``autodist_tpu/strategy/all_reduce_strategy.py:40-91``). ``chunk_size`` maps
the i-th parameter to collective fusion group ``i // chunk_size``."""

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer, NodeConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder

# Default mesh for the AllReduce family: pure data parallelism.
AR_DEFAULT_AXES = {const.MESH_AXIS_DATA: -1}

_Spec = AllReduceSynchronizer.Spec
_Comp = AllReduceSynchronizer.Compressor
_SPECS = {
    "AUTO": _Spec.AUTO, "ICI": _Spec.ICI, "DCN": _Spec.DCN,
    # The original AutoDist's spellings (NCCL ~ fast intra tier, RING ~ generic).
    "NCCL": _Spec.ICI, "RING": _Spec.DCN,
}
_COMPRESSORS = {
    "NoneCompressor": _Comp.NONE, "HorovodCompressor": _Comp.BF16,
    "HorovodCompressorEF": _Comp.BF16_EF, "PowerSGDCompressor": _Comp.POWER_SGD,
    "none": _Comp.NONE, "bf16": _Comp.BF16, "bf16_ef": _Comp.BF16_EF,
    "power_sgd": _Comp.POWER_SGD,
}


def parse_ar_options(chunk_size: int, all_reduce_spec: str, compressor: str):
    """Validate the AllReduce knobs; shared by every builder that emits
    AllReduce synchronizers. Returns ``(chunk_size, spec, compressor)``."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    if all_reduce_spec not in _SPECS:
        raise ValueError(f"Unknown all_reduce_spec {all_reduce_spec!r}; valid: {sorted(_SPECS)}")
    if compressor not in _COMPRESSORS:
        raise ValueError(f"Unknown compressor {compressor!r}; valid: {sorted(_COMPRESSORS)}")
    return chunk_size, _SPECS[all_reduce_spec], _COMPRESSORS[compressor]


def fill_ar_node_configs(strategy: Strategy, model_spec: ModelSpec, *, spec, compressor,
                         chunk_size: int, power_sgd_rank: int = 2) -> None:
    """One AllReduce synchronizer node per trainable parameter, the i-th in
    fusion group ``i // chunk_size``: the emission every replicated-parameter
    builder shares (AllReduce, SequenceParallel)."""
    for i, pspec in enumerate(model_spec.trainable.values()):
        ar = AllReduceSynchronizer(spec=spec, compressor=compressor, group=i // chunk_size)
        if compressor == _Comp.POWER_SGD:
            ar.power_sgd_rank = power_sgd_rank
        strategy.proto.node_config.append(NodeConfig(
            var_name=pspec.name, all_reduce_synchronizer=ar, sparse=pspec.sparse))


class AllReduce(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", power_sgd_rank: int = 2):
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)
        if power_sgd_rank < 1:
            raise ValueError("power_sgd_rank must be >= 1")
        self._power_sgd_rank = power_sgd_rank

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        fill_ar_node_configs(strategy, model_spec, spec=self._spec,
                             compressor=self._compressor, chunk_size=self._chunk_size,
                             power_sgd_rank=self._power_sgd_rank)
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, AR_DEFAULT_AXES))
        return strategy
