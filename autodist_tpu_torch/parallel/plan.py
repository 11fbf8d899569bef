"""Sharding plan: the executable form of a compiled Strategy
(``autodist_tpu/parallel/plan.py:44-442``).

Each parameter gets two partition specs in the JAX package's form, a tuple
with one entry per tensor axis (``None``, a mesh axis name, or a tuple of
names sharded as one flattened axis, the first name major; ``()`` is
replicated):

- ``pspec``, the parameter's storage: the partitioned axis on the
  ``model`` mesh axis when that axis has more than one rank (zero-padded to
  a multiple of its size when it does not tile: ``padded_dim`` /
  ``logical_dim``), else replicated;
- ``opt_pspec``, the optimizer state and the update: for a PS parameter the
  first free axis that tiles over ``reduce`` (weight-update sharding); with
  :meth:`ShardingPlan.with_zero_update` the first free axis that tiles over
  all data axes (ZeRO-1, arXiv 2004.13336); else the storage's own.

The runner (:mod:`autodist_tpu_torch.parallel.layout`) turns these into
each rank's slices and the collectives between them.
"""

import collections
import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec, ParamSpec
from autodist_tpu_torch.proto.strategy import AllReduceSynchronizer, NodeConfig

DP_AXES = (const.MESH_AXIS_DATA, const.MESH_AXIS_REDUCE)
SYNC_ALLREDUCE = "allreduce"
SYNC_PS = "ps"
COMP_NONE = AllReduceSynchronizer.Compressor.NONE
COMP_BF16 = AllReduceSynchronizer.Compressor.BF16
COMP_BF16_EF = AllReduceSynchronizer.Compressor.BF16_EF
COMP_POWER_SGD = AllReduceSynchronizer.Compressor.POWER_SGD

# One entry of a partition spec: no sharding, one mesh axis, or several as
# one flattened axis.
Entry = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[Entry, ...]


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """Compiled distribution of one parameter."""

    name: str
    pspec: PSpec = ()             # parameter storage sharding
    opt_pspec: PSpec = ()         # optimizer state / update sharding
    sync: str = SYNC_ALLREDUCE
    compressor: AllReduceSynchronizer.Compressor = COMP_NONE
    power_sgd_rank: int = 1
    group: int = 0                # collective fusion group (bucketing)
    spec: AllReduceSynchronizer.Spec = AllReduceSynchronizer.Spec.AUTO
    sparse: bool = False
    staleness: int = 0
    synchronous: bool = True
    partition_axis: Optional[int] = None   # tensor axis sharded on a mesh axis
    num_shards: Tuple[int, ...] = ()       # logical shard counts from the strategy
    partition_mesh_axis: str = const.MESH_AXIS_MODEL
    # Uneven partitioning: storage zero-padded to padded_dim along
    # partition_axis, sliced back to logical_dim around the user's loss.
    padded_dim: Optional[int] = None
    logical_dim: Optional[int] = None
    index_leaf: Optional[str] = None       # the sparse wire's index batch leaf
    shape: Tuple[int, ...] = ()            # logical shape

    @property
    def storage_shape(self) -> Tuple[int, ...]:
        """The global shape of the stored parameter (padded when uneven)."""
        shape = list(self.shape)
        if self.padded_dim is not None:
            shape[self.partition_axis] = self.padded_dim
        return tuple(shape)

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of the logical shape zero-padded to the storage shape
        (any other tensor as it is)."""
        ax = self.partition_axis
        if self.padded_dim is None or t.dim() <= ax or t.shape[ax] != self.logical_dim:
            return t
        widths = [0, 0] * t.dim()
        widths[2 * (t.dim() - 1 - ax) + 1] = self.padded_dim - self.logical_dim
        return torch.nn.functional.pad(t, widths)

    def unpad(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of the storage shape cut back to the logical shape (any
        other tensor as it is); the gradient through it is 0 in the pad."""
        ax = self.partition_axis
        if self.padded_dim is None or t.dim() <= ax or t.shape[ax] != self.padded_dim:
            return t
        return t.narrow(ax, 0, self.logical_dim)


class ShardingPlan:
    """Per-parameter plans plus the mesh shape, from a compiled Strategy."""

    # ZeRO weight-update sharding: off here, on in with_zero_update's copy.
    zero = False

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
                plans[name] = cls._plan_for(nodes.get(name), meta, mesh_axes)
        return cls(mesh_axes, plans)

    @staticmethod
    def _plan_for(node: Optional[NodeConfig], meta: ParamSpec, mesh_axes) -> ParamPlan:
        if node is None:
            # No config for this param: replicate + implicit all-reduce.
            return ParamPlan(name=meta.name, sparse=meta.sparse,
                             index_leaf=meta.index_leaf, shape=meta.shape)
        partition_axis, num_shards = None, ()
        partition_mesh_axis = const.MESH_AXIS_MODEL
        if node.partitioner is not None:
            num_shards = tuple(node.partitioner.num_shards)
            active = [i for i, k in enumerate(num_shards) if k > 1]
            if active:
                partition_axis = active[0]
            if node.partitioner.mesh_axis:
                partition_mesh_axis = node.partitioner.mesh_axis
        # Storage: the partition mesh axis on the partitioned tensor axis
        # when the mesh has it, zero-padded where the dim does not tile.
        axis_size = mesh_axes.get(partition_mesh_axis, 1)
        pspec: PSpec = ()
        padded_dim = logical_dim = None
        if partition_axis is not None and axis_size > 1:
            dims = [None] * len(meta.shape)
            dims[partition_axis] = partition_mesh_axis
            pspec = tuple(dims)
            dim = meta.shape[partition_axis]
            if dim % axis_size:
                logical_dim = dim
                padded_dim = -(-dim // axis_size) * axis_size
        kind = node.which_synchronizer()
        sync_node = node
        if kind is None and node.part_config:
            # Partitioned node: its children carry the (uniform) synchronizer.
            sync_node = node.part_config[0]
            kind = sync_node.which_synchronizer()
        common = dict(name=meta.name, pspec=pspec, sparse=meta.sparse or node.sparse,
                      partition_axis=partition_axis, num_shards=num_shards,
                      partition_mesh_axis=partition_mesh_axis, padded_dim=padded_dim,
                      logical_dim=logical_dim, index_leaf=meta.index_leaf,
                      shape=meta.shape)
        if kind == "ps_synchronizer":
            ps = sync_node.ps_synchronizer
            reduce_size = mesh_axes.get(const.MESH_AXIS_REDUCE, 1)
            opt = _first_tiling_axis_pspec(meta.shape, pspec, const.MESH_AXIS_REDUCE,
                                           reduce_size)
            return ParamPlan(opt_pspec=opt if opt is not None else pspec, sync=SYNC_PS,
                             staleness=ps.staleness, synchronous=ps.sync, **common)
        ar = sync_node.all_reduce_synchronizer if kind else AllReduceSynchronizer()
        return ParamPlan(opt_pspec=pspec, compressor=ar.compressor,
                         power_sgd_rank=max(1, ar.power_sgd_rank), group=ar.group,
                         spec=ar.spec, **common)

    # --------------------------------------------------------------- accessors
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

    @property
    def is_async(self) -> bool:
        """Any PS node asking for a non-synchronous regime (``sync=False`` or
        ``staleness > 0``): the async PS plane, not one synchronous step."""
        return any(p.sync == SYNC_PS and (not p.synchronous or p.staleness > 0)
                   for p in self.params.values())

    @property
    def max_staleness(self) -> int:
        return max((p.staleness for p in self.params.values()), default=0)

    def local(self, strategy, model_spec: ModelSpec) -> "ShardingPlan":
        """This plan on one device: every mesh axis of size 1 (the async PS
        runner's, whose processes each run their own program)."""
        if self.num_devices == 1:
            return self
        local = strategy.copy() if hasattr(strategy, "copy") else strategy
        for axis in local.mesh_config.axes:
            axis.size = 1
        return ShardingPlan.from_strategy(local, model_spec)

    @property
    def all_params_replicated(self) -> bool:
        return all(p.pspec == () for p in self.params.values())

    @property
    def has_padding(self) -> bool:
        return any(p.padded_dim is not None for p in self.params.values())

    @property
    def has_sharded_state(self) -> bool:
        """Some parameter or optimizer state is split across ranks."""
        return any(p.pspec != () or p.opt_pspec != () for p in self.params.values())

    @property
    def sparse_wire_params(self) -> Dict[str, ParamPlan]:
        """Sparse params that take the (indices, rows) wire: replicated
        storage, a known index leaf, no compressor."""
        return {n: p for n, p in self.params.items()
                if p.sparse and p.index_leaf and p.pspec == ()
                and p.compressor == COMP_NONE}

    # ------------------------------------------------- uneven (padded) storage
    def pad_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Zero-pad the unevenly partitioned tensors of ``{name: tensor}``
        to their storage shapes (names '/'-joined, as the plan keys them)."""
        return {n: self.params[n].pad(t) if n in self.params else t
                for n, t in params.items()}

    def unpad_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of :meth:`pad_params`: storage cut back to the
        logical shapes."""
        return {n: self.params[n].unpad(t) if n in self.params else t
                for n, t in params.items()}

    # ------------------------------------------------ ZeRO weight-update sharding
    def with_zero_update(self, mesh_axes: Optional[Dict[str, int]] = None) -> "ShardingPlan":
        """A copy with ZeRO-style weight-update sharding on: every parameter
        whose storage has a free axis that tiles over all the data axes
        shards its optimizer state and update there (the whole ``DP_AXES``
        as one flattened axis, data major); the others keep theirs."""
        axes = mesh_axes if mesh_axes is not None else self.mesh_axes
        dp = math.prod(axes.get(a, 1) for a in DP_AXES)
        params = {}
        for name, p in self.params.items():
            pspec = _first_tiling_axis_pspec(p.storage_shape, p.pspec, DP_AXES, dp)
            params[name] = dataclasses.replace(p, opt_pspec=pspec) if pspec is not None else p
        plan = ShardingPlan(self.mesh_axes, params)
        plan.zero = True
        return plan

    def __repr__(self):
        kinds = collections.Counter(p.sync for p in self.params.values())
        return f"ShardingPlan(mesh={dict(self.mesh_axes)}, {dict(kinds)})"


def _first_tiling_axis_pspec(shape, base_pspec: PSpec, axis_token: Entry,
                             divisor: int) -> Optional[PSpec]:
    """The one rule of both opt-state shardings (PS's ``reduce`` and ZeRO's
    all data axes): ``axis_token`` on the first tensor axis that the base
    spec leaves free and whose dim ``divisor`` divides; None when no axis
    tiles (``autodist_tpu/parallel/plan.py:345-363``)."""
    if divisor <= 1 or not shape:
        return None
    dims = list(base_pspec) if base_pspec and len(base_pspec) == len(shape) \
        else [None] * len(shape)
    for axis, dim in enumerate(shape):
        if dims[axis] is None and dim > 0 and dim % divisor == 0:
            dims[axis] = axis_token
            return tuple(dims)
    return None
