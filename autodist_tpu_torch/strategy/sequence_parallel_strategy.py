"""Sequence-parallel strategy: long sequences sharded over the ``seq`` mesh
axis (``autodist_tpu/strategy/sequence_parallel_strategy.py:20-58``).

Parameters stay replicated with AllReduce gradient sync; what changes is the
mesh: a ``seq`` axis of the requested size, which the sequence-parallel path
(:mod:`autodist_tpu_torch.parallel.sequence`, ring attention) binds to the
sequence dimension of the activations.
"""

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import (fill_ar_node_configs,
                                                             parse_ar_options)
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, num_devices


class SequenceParallel(StrategyBuilder):
    """Replicated params + AllReduce grad sync over a mesh with a ``seq`` axis.

    ``seq_axis_size``: size of the sequence axis (-1 = all devices). The
    remaining devices fill the ``data`` axis.
    """

    def __init__(self, seq_axis_size: int = -1, chunk_size: int = 128,
                 all_reduce_spec: str = "AUTO", compressor: str = "NoneCompressor"):
        if seq_axis_size == 0 or seq_axis_size < -1:
            raise ValueError("seq_axis_size must be -1 (all devices) or >= 1")
        self._seq_axis_size = seq_axis_size
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)
        if self._compressor != AllReduceSynchronizer.Compressor.NONE:
            # As in the JAX package, where the compressed sync cannot nest
            # inside the sequence-parallel loss's shard_map: refused at
            # construction, not mid-training.
            raise ValueError(
                "SequenceParallel does not support gradient compression: the "
                "sequence-parallel loss already runs inside a shard_map and the "
                "compressed sync path cannot nest within it")

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        n = num_devices(resource_spec)
        seq = n if self._seq_axis_size == -1 else self._seq_axis_size
        if n % seq != 0:
            raise ValueError(f"seq_axis_size={seq} does not divide {n} devices")
        strategy = Strategy()
        fill_ar_node_configs(strategy, model_spec, spec=self._spec,
                             compressor=self._compressor, chunk_size=self._chunk_size)
        axes = {const.MESH_AXIS_SEQ: seq, const.MESH_AXIS_DATA: -1}
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, axes))
        return strategy
