"""Random-axis partitioned AllReduce strategy
(``autodist_tpu/strategy/random_axis_partition_all_reduce_strategy.py``):
PartitionedAR on an axis of size >= 2 drawn from a seeded ``random.Random``
(so every rank draws the same axes), axis 0 for sparse parameters."""

import random

from autodist_tpu_torch.strategy.partition_utils import smallest_divisor_at_least_2
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR


class RandomAxisPartitionAR(PartitionedAR):
    def __init__(self, chunk_size: int = 128, seed: int = 0, **kwargs):
        super().__init__(chunk_size=chunk_size, **kwargs)
        self._rng = random.Random(seed)

    def _choose_axis_and_count(self, spec, seed_idx: int):
        if spec.sparse:
            axis = 0 if spec.shape and spec.shape[0] >= 2 else None
        else:
            candidates = [i for i, d in enumerate(spec.shape) if d >= 2]
            axis = self._rng.choice(candidates) if candidates else None
        if axis is None:
            return None, None
        return axis, smallest_divisor_at_least_2(spec.shape[axis])
