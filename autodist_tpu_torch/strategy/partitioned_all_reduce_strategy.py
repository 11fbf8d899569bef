"""Partitioned AllReduce strategy
(``autodist_tpu/strategy/partitioned_all_reduce_strategy.py``): each
parameter's dim 0 is split into its smallest divisor >= 2 of shards on the
``model`` mesh axis, and each shard all-reduces, its fusion group taken from
a running shard counter."""

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer, NodeConfig, PartitionConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import parse_ar_options
from autodist_tpu_torch.strategy.base import AR_DEFAULT_AXES, Strategy, StrategyBuilder
from autodist_tpu_torch.strategy.partition_utils import (make_num_shards, partitionable_axis,
                                                         smallest_divisor_at_least_2)


class PartitionedAR(StrategyBuilder):
    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor"):
        self._chunk_size, self._spec, self._compressor = parse_ar_options(
            chunk_size, all_reduce_spec, compressor)

    def _choose_axis_and_count(self, spec, seed_idx: int):
        axis = partitionable_axis(spec)
        if axis is None:
            return None, None
        return axis, smallest_divisor_at_least_2(spec.shape[axis])

    def _ar(self, counter: int) -> AllReduceSynchronizer:
        return AllReduceSynchronizer(spec=self._spec, compressor=self._compressor,
                                     group=counter // self._chunk_size)

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        counter = 0  # running shard counter -> group ids
        for idx, spec in enumerate(model_spec.trainable.values()):
            node = NodeConfig(var_name=spec.name, sparse=spec.sparse)
            strategy.proto.node_config.append(node)
            axis, k = self._choose_axis_and_count(spec, idx)
            if axis is None or k is None or k < 2:
                node.all_reduce_synchronizer = self._ar(counter)
                counter += 1
                continue
            node.partitioner = PartitionConfig(
                num_shards=list(make_num_shards(len(spec.shape), axis, k)),
                mesh_axis=const.MESH_AXIS_MODEL)
            for i in range(k):
                node.part_config.append(NodeConfig(
                    var_name=f"{spec.name}/part_{i}", sparse=spec.sparse,
                    all_reduce_synchronizer=self._ar(counter)))
                counter += 1
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, AR_DEFAULT_AXES))
        return strategy
