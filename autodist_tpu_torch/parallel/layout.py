"""Each rank's share of a sharding plan's tensors, and the collectives that
move between the shares.

The JAX package states a layout as a ``PartitionSpec`` and lets XLA place
the shards and insert the collectives (``autodist_tpu/parallel/plan.py``,
``constrain_update``/``constrain_opt``/``constrain_params``). Here each rank
holds its own slice and the collectives are explicit, over the mesh's
sub-groups (:mod:`autodist_tpu_torch.parallel.mesh`). A spec entry of
several mesh axes is one flattened axis, the first major: chunk ``i`` of
the tensor axis goes to the rank whose row-major index over those axes is
``i``, which is its rank within the sub-group along them (groups list their
ranks in ascending order, the mesh's row-major order).

Per parameter (``StateLayout.params[name]``):

- storage: the parameter's ``pspec`` slice of its padded global shape (a
  model-axis shard, or the whole tensor);
- update: the part of the storage the optimizer updates on this rank,
  ``opt_pspec``'s slice (a ``reduce`` or all-data-axes shard of one tensor
  axis under PS or ZeRO, else the whole storage);
- what the loss reads (:meth:`StateLayout.compute_view`): a ``model``-axis
  shard gathered to the logical shape (the JAX package's gather-then-compute),
  but an ``expert``- or ``pipe``-axis shard as it is stored, since each rank
  computes with only its experts or its stage (``COMPUTE_LOCAL_AXES``).
"""

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.mesh import DeviceMesh
from autodist_tpu_torch.parallel.plan import PSpec, ParamPlan, ShardingPlan, entry_axes

# Mesh axes whose shards the loss computes with in place (no gather).
COMPUTE_LOCAL_AXES = (const.MESH_AXIS_EXPERT, const.MESH_AXIS_PIPE)


def spec_ranges(pspec: PSpec, shape: Sequence[int], mesh: DeviceMesh,
                coords: Optional[Dict[str, int]] = None) -> Tuple[Tuple[int, int], ...]:
    """``(start, stop)`` per tensor axis of the chunk that the rank at
    ``coords`` (default: this rank) holds of a tensor of global ``shape``
    laid out by ``pspec``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, size in enumerate(shape):
        axes = entry_axes(pspec[dim]) if dim < len(pspec) else ()
        n = math.prod(mesh.shape.get(a, 1) for a in axes)
        idx = 0
        for a in mesh.shape:
            if a in axes:
                idx = idx * mesh.shape[a] + coords[a]
        per = size // n
        out.append((idx * per, (idx + 1) * per))
    return tuple(out)


def spec_owner(pspec: PSpec, mesh: DeviceMesh, coords: Dict[str, int]) -> bool:
    """Whether the rank at ``coords`` is the lowest rank holding its chunk of
    a tensor laid out by ``pspec`` (its coordinate is 0 on every mesh axis
    the spec does not use): the rank that writes the chunk to a sharded
    checkpoint."""
    used = {a for entry in pspec for a in entry_axes(entry)}
    return all(c == 0 for a, c in coords.items() if a not in used)


def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``t`` along tensor axis ``dim`` over ``group`` (chunk i
    from group rank i)."""
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


@dataclasses.dataclass
class ParamLayout:
    """This rank's share of one parameter."""

    plan: ParamPlan
    key: str                      # state-dict key
    trainable: bool
    storage: Tuple[slice, ...]    # of the padded global shape
    update_dim: Optional[int]     # tensor axis of the update shard, if any
    update_axes: Tuple[str, ...]  # mesh axes it is sharded over
    update: Tuple[slice, ...]     # of the local storage

    @property
    def sharded_update(self) -> bool:
        return self.update_dim is not None

    @property
    def model_sharded(self) -> bool:
        return self.plan.pspec != ()

    @property
    def compute_local(self) -> bool:
        """The loss reads this rank's storage itself (an ``expert`` or
        ``pipe`` shard), not the gathered logical tensor."""
        return self.model_sharded and self.plan.partition_mesh_axis in COMPUTE_LOCAL_AXES


class StateLayout:
    """The layout of every parameter of a plan on this rank of ``mesh``."""

    def __init__(self, plan: ShardingPlan, model_spec: ModelSpec, mesh: DeviceMesh):
        self.plan = plan
        self.mesh = mesh
        self.params: Dict[str, ParamLayout] = {}
        for name, meta in model_spec.params.items():
            p = plan.params[name]
            shape = p.storage_shape
            storage = spec_ranges(p.pspec, shape, mesh)
            update_dim, update_axes, update = None, (), tuple(slice(None) for _ in shape)
            if meta.trainable:
                for dim, entry in enumerate(p.opt_pspec):
                    base = p.pspec[dim] if dim < len(p.pspec) else None
                    if entry is not None and entry != base:
                        update_dim, update_axes = dim, entry_axes(entry)
                local = [b - a for a, b in storage]
                if update_dim is not None:
                    a, b = spec_ranges(p.opt_pspec, shape, mesh)[update_dim]
                    lo = storage[update_dim][0]
                    update = tuple(slice(a - lo, b - lo) if d == update_dim else slice(None)
                                   for d in range(len(local)))
            self.params[name] = ParamLayout(
                plan=p, key=model_spec.keys[name], trainable=meta.trainable,
                storage=tuple(slice(a, b) for a, b in storage), update_dim=update_dim,
                update_axes=update_axes, update=update)
        self.by_key = {pl.key: pl for pl in self.params.values()}

    @property
    def has_model_storage(self) -> bool:
        return any(pl.model_sharded for pl in self.params.values())

    # ------------------------------------------------ logical <-> storage
    def to_storage(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's storage of a logical-shape tensor (a view when the
        storage is the whole tensor)."""
        pl = self.by_key[key]
        if not pl.model_sharded:
            return full
        return pl.plan.pad(full)[pl.storage]

    def gather(self, local: torch.Tensor, pspec: PSpec) -> torch.Tensor:
        """The global (padded) tensor from each rank's ``pspec`` chunk: an
        all-gather along each sharded tensor axis over its mesh axes."""
        for dim, entry in enumerate(pspec):
            axes = entry_axes(entry)
            group = self.mesh.group(axes) if axes else None
            if group is not None:
                local = _gather_dim(local, dim, group, self.mesh.axes_size(axes))
        return local

    def logical(self, key: str, storage: torch.Tensor) -> torch.Tensor:
        """The parameter at its logical shape: sharded storage gathered and
        unpadded (a collective: every rank calls it); replicated storage as
        it is."""
        pl = self.by_key[key]
        if not pl.model_sharded:
            return storage
        with torch.no_grad():
            return pl.plan.unpad(self.gather(storage.detach(), pl.plan.pspec))

    def compute_view(self, key: str, storage: torch.Tensor) -> torch.Tensor:
        """What the loss reads of a parameter: the storage itself where it is
        whole or computed with in place (``compute_local``), else a fresh
        leaf of the gathered logical tensor."""
        pl = self.by_key[key]
        if not pl.model_sharded or pl.compute_local:
            return storage
        return self.logical(key, storage).detach().requires_grad_(pl.trainable)

    def grad_to_storage(self, key: str, grad: torch.Tensor) -> torch.Tensor:
        """A gradient of :meth:`compute_view`'s tensor as the storage's."""
        return grad if self.by_key[key].compute_local else self.to_storage(key, grad)

    # ------------------------------------------------------------- updates
    def update_chunk(self, key: str):
        """Where the optimizer's tensor of ``key`` lies in the padded
        parameter: ``(ranges, cut)`` with ``ranges`` its ``(start, stop)``
        per tensor axis, and ``cut`` None when it is the whole parameter,
        else ``(dim, mesh axes)`` of the one axis it is cut along (its
        update shard's, or its storage shard's). A tensor cut along two
        axes raises: nothing the port runs lays one out so."""
        pl = self.by_key[key]
        shape = pl.plan.storage_shape
        storage = spec_ranges(pl.plan.pspec, shape, self.mesh)
        update = spec_ranges(pl.plan.opt_pspec, shape, self.mesh) if pl.sharded_update \
            else storage
        ranges, cuts = [], []
        for dim, size in enumerate(shape):
            r = update[dim] if dim == pl.update_dim else storage[dim]
            ranges.append(r)
            if r != (0, size):
                spec = pl.plan.opt_pspec if dim == pl.update_dim else pl.plan.pspec
                cuts.append((dim, entry_axes(spec[dim])))
        if len(cuts) > 1:
            raise NotImplementedError(f"{key}: the optimizer's tensor is cut along dims "
                                      f"{[d for d, _ in cuts]}; one cut axis is supported")
        return tuple(ranges), (cuts[0] if cuts else None)

    def to_update(self, key: str, storage: torch.Tensor) -> torch.Tensor:
        """The update shard of a storage-shaped tensor (a view)."""
        pl = self.by_key[key]
        return storage[pl.update] if pl.sharded_update else storage

    def gather_updates(self, keys: List[str], shards: Dict[str, torch.Tensor],
                       storage: Dict[str, torch.Tensor]) -> None:
        """All-gather the updated shards of parameters whose updates shard
        over the same mesh axes into their storage: one
        ``all_gather_into_tensor`` (each shard's axis moved to the front and
        flattened, side by side), the all-gather that closes the sharded
        update."""
        pl0 = self.by_key[keys[0]]
        group = self.mesh.group(pl0.update_axes)
        n = self.mesh.axes_size(pl0.update_axes)
        moved = [shards[k].detach().movedim(self.by_key[k].update_dim, 0) for k in keys]
        flat = torch.cat([m.reshape(-1) for m in moved])
        out = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=group)
        out = out.view(n, -1)
        with torch.no_grad():
            for k, m, piece in zip(keys, moved, out.split([m.numel() for m in moved], dim=1)):
                full = piece.reshape((n * m.shape[0],) + tuple(m.shape[1:]))
                storage[k].copy_(full.movedim(0, self.by_key[k].update_dim))

    def reduce_scatter(self, keys: List[str], grads: Dict[str, torch.Tensor],
                       rest_group) -> Dict[str, torch.Tensor]:
        """The summed update shards of storage-shaped gradients whose updates
        shard over the same mesh axes: one ``reduce_scatter_tensor`` over
        them (each gradient's shard axis moved to the front and chunked,
        the chunks of all gradients side by side), then an all-reduce of the
        shards over ``rest_group`` (the other reduced axes) when it is
        not None."""
        pl0 = self.by_key[keys[0]]
        group = self.mesh.group(pl0.update_axes)
        n = self.mesh.axes_size(pl0.update_axes)
        moved = [grads[k].movedim(self.by_key[k].update_dim, 0) for k in keys]
        flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
        out = flat.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(out, flat.reshape(-1), group=group)
        if rest_group is not None:
            dist.all_reduce(out, group=rest_group)
        shards = {}
        for k, m, piece in zip(keys, moved, out.split([m.numel() // n for m in moved])):
            shape = (m.shape[0] // n,) + tuple(m.shape[1:])
            shards[k] = piece.view(shape).movedim(0, self.by_key[k].update_dim)
        return shards
