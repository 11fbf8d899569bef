"""The device mesh (``autodist_tpu/parallel/mesh.py:26-108``).

The port runs one process per device, so a mesh is a grid of ranks: the
world's ranks reshaped row-major over ``STANDARD_AXES``, as the JAX package
reshapes its devices (rank ``data_index * seq_size + seq_index`` on a
data x seq mesh). Every set of the axes of more than one rank gets the
process groups along it: the training path reduces over the data axes (and
``seq``), reduce-scatters and all-gathers a sharded update over ``reduce``
or all data axes, and gathers model-axis storage over ``model``.

A mesh is made current with ``with mesh:``, as the JAX runner steps inside
``with mesh:`` (``autodist_tpu/parallel/pipeline.py:452-469``): the runner
does so around every call of the loss, and model code finds its groups and
coordinates through :func:`current_mesh` (the MoE's ``expert`` group, the
pipeline's ``pipe`` ranks). A mesh may run some axes in this one process
(``virtual``): :func:`replay_mesh` stands for every rank along them, which
is how the pipeline schedules replay ``S`` stages on one card.
"""

import collections
import contextlib
import contextvars
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from autodist_tpu_torch import const


# Canonical axis order. Axes the user does not size default to 1.
STANDARD_AXES = (
    const.MESH_AXIS_DATA,
    const.MESH_AXIS_REDUCE,
    const.MESH_AXIS_MODEL,
    const.MESH_AXIS_SEQ,
    const.MESH_AXIS_EXPERT,
    const.MESH_AXIS_PIPE,
)


def standard_mesh_shape(n_devices: int, axes: Optional[Dict[str, int]] = None
                        ) -> "collections.OrderedDict":
    """Resolve a possibly-partial axis-size dict into a full OrderedDict over
    STANDARD_AXES. A value of ``-1`` (or an unspecified ``data`` axis) absorbs
    the remaining devices. Raises if the product does not match ``n_devices``."""
    axes = dict(axes or {})
    unknown = set(axes) - set(STANDARD_AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {sorted(unknown)}; valid: {STANDARD_AXES}")
    shape = collections.OrderedDict((a, int(axes.get(a, 1))) for a in STANDARD_AXES)
    if const.MESH_AXIS_DATA not in axes:
        shape[const.MESH_AXIS_DATA] = -1
    bad = {a: s for a, s in shape.items() if s != -1 and s < 1}
    if bad:
        raise ValueError(f"Mesh axis sizes must be >= 1 (or -1 to fill), got {bad}")
    fill_axes = [a for a, s in shape.items() if s == -1]
    if len(fill_axes) > 1:
        raise ValueError(f"At most one -1 axis allowed, got {fill_axes}")
    fixed = math.prod(s for s in shape.values() if s != -1)
    if fill_axes:
        if n_devices % fixed != 0:
            raise ValueError(
                f"Cannot fill axis {fill_axes[0]}: {n_devices} devices not divisible by {fixed}")
        shape[fill_axes[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(f"Mesh axes {dict(shape)} require {fixed} devices, have {n_devices}")
    return shape


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("current_mesh", default=None)


def current_mesh() -> Optional["DeviceMesh"]:
    """The mesh made current by the innermost ``with mesh:`` (None outside)."""
    return _CURRENT.get()


@contextlib.contextmanager
def step_mesh(mesh: Optional["DeviceMesh"]):
    """``mesh`` current (None: no mesh) while a step or an evaluation runs:
    ``synchronization.global_mean`` reduces over its ranks, and model code
    finds its groups there."""
    token = _CURRENT.set(mesh)
    try:
        yield
    finally:
        _CURRENT.reset(token)


class DeviceMesh:
    """A named grid of ranks, this process's place in it, and the process
    groups along its axes. ``group(axes)`` is the group of the ranks that
    differ from this one only along ``axes``: ``None`` when that is this
    rank alone, the world group when it is every rank. ``virtual`` names
    axes whose ranks all run in this process (no group along them).
    ``with mesh:`` makes it the current mesh."""

    def __init__(self, shape: "collections.OrderedDict[str, int]", rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], "dist.ProcessGroup"]] = None,
                 virtual: Sequence[str] = ()):
        self.shape = collections.OrderedDict(shape)
        self.rank = rank
        self.coords = {a: int(c) for a, c in zip(
            self.shape, np.unravel_index(rank, tuple(self.shape.values())))}
        self._groups = dict(groups or {})
        self.virtual = tuple(virtual)
        self._tokens: List[contextvars.Token] = []

    def __enter__(self) -> "DeviceMesh":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def _live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in self.shape if a in axes and self.shape[a] > 1)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (its data index over
        ``("data", "reduce")``)."""
        idx = 0
        for a in self.shape:
            if a in axes:
                idx = idx * self.shape[a] + int(self.coords[a])
        return idx

    def group(self, axes: Sequence[str]) -> Optional["dist.ProcessGroup"]:
        if any(a in self.virtual for a in axes if self.shape.get(a, 1) > 1):
            raise ValueError(f"mesh axes {tuple(axes)} run in this process ({self.virtual} "
                             f"are virtual): they have no process group")
        live = self._live(axes)
        if not live:
            return None
        if live == self._live(tuple(self.shape)):
            return dist.group.WORLD
        return self._groups[live]


def _subgroup_members(shape: "collections.OrderedDict[str, int]",
                      live: Tuple[str, ...]):
    """Every sub-group along the axes ``live``, as rank lists, in one order
    all ranks share: for each setting of the other axes (row-major), the
    ranks varying along ``live``."""
    ranks = np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
    names = list(shape)
    keep = [names.index(a) for a in live]
    rest = [i for i in range(len(names)) if i not in keep]
    moved = ranks.transpose(rest + keep).reshape(-1, math.prod(shape[a] for a in live))
    return [row.tolist() for row in moved]


def build_mesh(resource_spec=None, axes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """The mesh over the joined process group's ranks (one rank when no
    group is up). ``axes`` overrides the resource spec's ``mesh:`` section;
    their product must be the world size. With more than one rank, every
    rank must call this with the same arguments: each creates every
    sub-group with ``dist.new_group`` in the same order."""
    world_size = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None and resource_spec is not None:
        axes = resource_spec.mesh_config
    shape = standard_mesh_shape(world_size, axes)
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups = {}
    every = tuple(a for a in shape if shape[a] > 1)
    for n in range(1, len(every)):
        for live in itertools.combinations(every, n):
            for members in _subgroup_members(shape, live):
                group = dist.new_group(members)
                if rank in members:
                    groups[live] = group
    return DeviceMesh(shape, rank, groups)


def joined_mesh(axes: Dict[str, int]) -> Optional[DeviceMesh]:
    """:func:`build_mesh` over ``axes`` when the joined world has their
    device count, else None (the runner then names the mismatch)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return build_mesh(axes=axes) if world == math.prod(axes.values()) else None


def data_axis_size(mesh: DeviceMesh) -> int:
    return mesh.shape[const.MESH_AXIS_DATA]


def single_device_mesh() -> DeviceMesh:
    """A mesh of one rank (the original single-node step)."""
    return DeviceMesh(standard_mesh_shape(1, {const.MESH_AXIS_DATA: 1}))


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (the cost probe's and the sparse walk's
    traces): collectives of model code skip it, as no group runs there."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def replay_mesh(axes: Dict[str, int]) -> DeviceMesh:
    """A mesh of ``axes`` whose every axis of more than one rank runs in this
    process: code that reads it computes every rank along those axes itself
    (the pipeline schedules' one-process replay)."""
    shape = standard_mesh_shape(math.prod(axes.values()), axes)
    return DeviceMesh(shape, virtual=tuple(a for a, n in shape.items() if n > 1))
