"""Shard-count policies shared by the partitioned strategy builders (the
port's copy of ``autodist_tpu/strategy/partition_utils.py:1-57``): the
smallest divisor of dim 0 for even partitioning, the smallest non-divisor
for the uneven variant, the partitionable axis and the per-axis shard
counts with one active axis."""

from typing import Optional, Tuple

from autodist_tpu_torch.model_spec import ParamSpec


def smallest_divisor_at_least_2(n: int, cap: Optional[int] = None) -> Optional[int]:
    """Smallest k >= 2 dividing n (None if n < 2 or no divisor <= cap)."""
    if n < 2:
        return None
    k = 2
    while k * k <= n:
        if n % k == 0:
            break
        k += 1
    else:
        k = n  # n is prime: its smallest divisor >= 2 is itself
    if cap is not None and k > cap:
        return None
    return k


def smallest_non_divisor_at_least_2(n: int, cap: Optional[int] = None) -> Optional[int]:
    """Smallest k >= 2 NOT dividing n (None if n < 2 or k exceeds cap)."""
    if n < 2:
        return None
    k = 2
    while n % k == 0:
        k += 1
    if cap is not None and k > cap:
        return None
    return k


def partitionable_axis(spec: ParamSpec) -> Optional[int]:
    """The tensor axis eligible for partitioning: axis 0 when it has at
    least 2 rows, else None (sparse parameters must partition axis 0, so
    row updates stay shard-local)."""
    if not spec.shape or spec.shape[0] < 2:
        return None
    return 0


def make_num_shards(rank: int, axis: int, k: int) -> Tuple[int, ...]:
    """Per-axis shard counts with one active axis (``k`` on ``axis``)."""
    return tuple(k if i == axis else 1 for i in range(max(rank, 1)))
