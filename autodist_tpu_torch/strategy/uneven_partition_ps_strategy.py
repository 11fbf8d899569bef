"""Uneven-partition PS strategy
(``autodist_tpu/strategy/uneven_partition_ps_strategy.py``): PartitionedPS
with the smallest non-divisor >= 2 of dim 0 as the shard count, so shards
are uneven and storage on the ``model`` axis is padded."""

from autodist_tpu_torch.strategy.partition_utils import smallest_non_divisor_at_least_2
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS


class UnevenPartitionedPS(PartitionedPS):
    @staticmethod
    def _shard_count(dim0: int, cap: int):
        return smallest_non_divisor_at_least_2(dim0, cap)
