"""Sharding plan: the executable form of a compiled Strategy
(``autodist_tpu/parallel/plan.py:77-130``).

Ported so far: replicated parameters under the AllReduce synchronizer, whose
gradient sum is the implicit all-reduce of data parallelism, over a mesh
that may carry a ``seq`` axis (sequence parallelism). PS synchronizers and
partitioned parameters raise ``NotImplementedError``.
"""

import collections
import dataclasses
import math
from typing import Dict, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec, ParamSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer, NodeConfig

DP_AXES = (const.MESH_AXIS_DATA, const.MESH_AXIS_REDUCE)
SYNC_ALLREDUCE = "allreduce"
COMP_NONE = AllReduceSynchronizer.Compressor.NONE


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """Compiled distribution of one replicated parameter."""

    name: str
    sync: str = SYNC_ALLREDUCE
    compressor: AllReduceSynchronizer.Compressor = COMP_NONE
    power_sgd_rank: int = 1
    group: int = 0                # collective fusion group (bucketing)
    spec: AllReduceSynchronizer.Spec = AllReduceSynchronizer.Spec.AUTO
    sparse: bool = False
    shape: Tuple[int, ...] = ()


class ShardingPlan:
    """Per-parameter plans plus the mesh shape, from a compiled Strategy."""

    def __init__(self, mesh_axes: "collections.OrderedDict[str, int]",
                 params: Dict[str, ParamPlan]):
        self.mesh_axes = mesh_axes
        self.params = params

    @classmethod
    def from_strategy(cls, strategy, model_spec: ModelSpec) -> "ShardingPlan":
        mc = strategy.mesh_config
        mesh_axes = collections.OrderedDict(
            (a.name, a.size) for a in (mc.axes if mc is not None else ()))
        nodes = {n.var_name: n for n in strategy.node_config}
        plans = {}
        for name, meta in model_spec.params.items():
            if not meta.trainable:
                plans[name] = ParamPlan(name=name, shape=meta.shape)
            else:
                plans[name] = cls._plan_for(nodes.get(name), meta)
        return cls(mesh_axes, plans)

    @staticmethod
    def _plan_for(node: NodeConfig, meta: ParamSpec) -> ParamPlan:
        if node is None:
            # No config for this param: replicate + implicit all-reduce.
            return ParamPlan(name=meta.name, sparse=meta.sparse, shape=meta.shape)
        if node.partitioner is not None or node.part_config:
            raise NotImplementedError(
                f"{meta.name}: partitioned parameters are not ported yet")
        if node.which_synchronizer() != "all_reduce_synchronizer":
            raise NotImplementedError(
                f"{meta.name}: only the AllReduce synchronizer is ported "
                f"(got {node.which_synchronizer()})")
        ar = node.all_reduce_synchronizer
        return ParamPlan(name=meta.name, compressor=ar.compressor,
                         power_sgd_rank=max(1, ar.power_sgd_rank), group=ar.group,
                         spec=ar.spec, sparse=meta.sparse or node.sparse,
                         shape=meta.shape)

    @property
    def dp_size(self) -> int:
        """Data replicas: the data axes only, not ``seq``."""
        return (self.mesh_axes.get(const.MESH_AXIS_DATA, 1)
                * self.mesh_axes.get(const.MESH_AXIS_REDUCE, 1))

    def batch_rows(self, n_rows: int, data_index: int) -> slice:
        """The rows of a leading dim of ``n_rows`` that data rank
        ``data_index`` holds: its contiguous ``1/dp`` chunk, the data axes
        taken together, data major (``batch_pspec``,
        ``autodist_tpu/parallel/plan.py:269-272``)."""
        dp = self.dp_size
        if n_rows % dp:
            raise ValueError(f"a leading dim of {n_rows} does not split over {dp} data ranks")
        per = n_rows // dp
        return slice(data_index * per, (data_index + 1) * per)

    @property
    def seq_size(self) -> int:
        return self.mesh_axes.get(const.MESH_AXIS_SEQ, 1)

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh_axes.values())

    @property
    def has_compression(self) -> bool:
        return any(p.compressor != COMP_NONE for p in self.params.values())
