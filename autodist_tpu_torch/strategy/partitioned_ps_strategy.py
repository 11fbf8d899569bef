"""Partitioned PS strategy (``autodist_tpu/strategy/partitioned_ps_strategy.py``):
each parameter's dim 0 is split into its smallest divisor >= 2 of shards,
placed greedily by load, emitted as ``partitioner`` + ``part_config``
children mapped onto the ``model`` mesh axis. Parameters that cannot be
partitioned fall back to load-balanced PS."""

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.proto.strategy import NodeConfig, PartitionConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.strategy.partition_utils import (make_num_shards, partitionable_axis,
                                                         smallest_divisor_at_least_2)
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing


class PartitionedPS(PSLoadBalancing):
    """PS with per-parameter variable partitioning."""

    # Shard-count policy; the uneven variant overrides this hook alone.
    @staticmethod
    def _shard_count(dim0: int, cap: int):
        return smallest_divisor_at_least_2(dim0, cap)

    def build(self, model_spec: ModelSpec, resource_spec: ResourceSpec) -> Strategy:
        strategy = Strategy()
        n_dest = self._num_destinations(resource_spec)
        loads = [0] * n_dest
        for spec in model_spec.trainable.values():
            node = NodeConfig(var_name=spec.name, sparse=spec.sparse)
            strategy.proto.node_config.append(node)
            axis = partitionable_axis(spec)
            k = self._shard_count(spec.shape[axis], n_dest * 4) if axis is not None else None
            if k is None or k < 2:
                dest = min(range(n_dest), key=loads.__getitem__)
                loads[dest] += self._load_fn(spec)
                node.ps_synchronizer = self._ps(dest)
                continue
            node.partitioner = PartitionConfig(
                num_shards=list(make_num_shards(len(spec.shape), axis, k)),
                mesh_axis=const.MESH_AXIS_MODEL)
            shard_load = max(self._load_fn(spec) // k, 1)
            for i in range(k):
                dest = min(range(n_dest), key=loads.__getitem__)
                loads[dest] += shard_load
                node.part_config.append(NodeConfig(
                    var_name=f"{spec.name}/part_{i}", sparse=spec.sparse,
                    ps_synchronizer=self._ps(dest)))
        self._fill_mesh_config(strategy, resource_spec,
                               self._resolved_axes(resource_spec, self._default_axes))
        return strategy
