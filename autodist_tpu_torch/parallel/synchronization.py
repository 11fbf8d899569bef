"""Gradient synchronization (``autodist_tpu/parallel/synchronization.py:165-223``).

The *implicit* lowering. Under JAX the loss is one function of the global
batch and XLA inserts the gradient all-reduce; here every rank runs the loss
on its own rows (one process per device), differentiates it, and one
all-reduce of a flat buffer over the data and seq ranks combines the
gradients: averaged over the data ranks, summed over the seq ranks (the
transpose of the sequence-parallel loss's ``psum``,
``autodist_tpu/parallel/sequence.py:67-70``).

What that asks of a loss under data parallelism:

- a plain mean over the same number of rows on every rank is exact: the
  average of the ranks' means is the global mean;
- a loss normalised by a count that depends on the data (a masked token
  mean) must reduce the count over the data ranks with :func:`global_mean`,
  whose value is the global mean and whose gradient is scaled so that the
  average over the data ranks is the global mean's gradient.

The reported loss is averaged over the same ranks, so it is the global one.
Gradient compression and the explicit lowering raise ``NotImplementedError``.
"""

import contextlib
import contextvars
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.mesh import DeviceMesh
from autodist_tpu_torch.parallel.plan import DP_AXES, ShardingPlan

SYNC_AXES = DP_AXES + (const.MESH_AXIS_SEQ,)

_STEP_MESH: contextvars.ContextVar = contextvars.ContextVar("step_mesh", default=None)


@contextlib.contextmanager
def step_mesh(mesh: Optional[DeviceMesh]):
    """The mesh whose step (or evaluation) is running: :func:`global_mean`
    reduces over its ranks."""
    token = _STEP_MESH.set(mesh)
    try:
        yield
    finally:
        _STEP_MESH.reset(token)


def global_mean(total: torch.Tensor, count: torch.Tensor, axes: Sequence[str] = DP_AXES,
                group: Optional["dist.ProcessGroup"] = None) -> torch.Tensor:
    """``sum(total) / max(sum(count), 1)`` over the ranks of the running
    step's mesh along ``axes``; outside a step, over ``group`` (None: this
    rank alone). The value is that global mean on every rank; the gradient
    is this rank's share of it times the number of data ranks, which the
    runner's average over the data ranks turns back into the global mean's
    gradient."""
    mesh = _STEP_MESH.get()
    dp = 1
    if mesh is not None:
        group, dp = mesh.group(axes), mesh.axes_size(DP_AXES)
    sums = torch.stack([total.detach(), count.detach().to(total.dtype)])
    if group is not None:
        dist.all_reduce(sums, group=group)
    denom = torch.clamp(sums[1], min=1.0)
    local = total * dp / denom
    return local + (sums[0] / denom - local).detach()


def _detached(tree):
    """The aux tree with every tensor detached: holding the graph would keep
    each micro-batch's activations alive through the whole step."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _group_size(mesh: Optional[DeviceMesh], axes) -> int:
    group = mesh.group(axes) if mesh is not None else None
    return 1 if group is None else dist.get_world_size(group)


def make_grad_fn(sharding_plan: ShardingPlan, model_spec: ModelSpec,
                 mesh: Optional[DeviceMesh], loss_fn: Callable,
                 has_aux: bool = False) -> Callable:
    """``grad_fn(params, batch) -> (grads, loss, aux)``: ``params`` maps
    state-dict keys to leaf tensors that require grad, ``grads`` maps the
    same keys to the synchronized gradients, ``loss`` is the detached global
    loss and ``aux`` the loss function's auxiliary output (``()`` without
    ``has_aux``), computed on this rank's rows. ``grad_fn.local`` is the same
    without the all-reduce and ``grad_fn.sync(grads, loss)`` the all-reduce
    alone, so that gradient accumulation reduces once a step. ``mesh`` is the
    mesh of joined ranks (None when no group of the plan's size is up, which
    raises for a plan of more than one rank)."""
    if sharding_plan.has_compression:
        raise NotImplementedError("gradient compression is not ported yet")
    dp, seq = sharding_plan.dp_size, sharding_plan.seq_size
    for axes, size, what in ((DP_AXES, dp, "data axes have"),
                             ((const.MESH_AXIS_SEQ,), seq, "seq axis has")):
        joined = _group_size(mesh, axes)
        if joined != size:
            group = "data group" if axes == DP_AXES else "seq group"
            raise RuntimeError(f"the mesh's {what} {size} ranks but the {group} has "
                               f"{joined}: join the process group first (torchrun)")
    group = mesh.group(SYNC_AXES) if mesh is not None else None
    ranks = _group_size(mesh, SYNC_AXES)
    keys = [model_spec.keys[n] for n in model_spec.trainable]

    def local(params: Mapping[str, torch.Tensor], batch) -> tuple:
        with step_mesh(mesh):
            out = loss_fn(params, batch)
        loss, aux = out if has_aux else (out, ())
        # An unused parameter gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        return dict(zip(keys, grads)), loss.detach(), _detached(aux)

    def sync(grads: Dict[str, torch.Tensor], loss: torch.Tensor) -> tuple:
        if group is None:
            return grads, loss
        parts = list(grads.values())
        flat = torch.cat([g.reshape(-1) for g in parts]
                         + [loss.reshape(1).to(parts[0].dtype)])
        dist.all_reduce(flat, group=group)
        pieces = flat.split([g.numel() for g in parts] + [1])
        synced = {k: p.view(g.shape).to(g.dtype) / dp
                  for (k, g), p in zip(grads.items(), pieces)}
        return synced, (pieces[-1][0] / ranks).to(loss.dtype)

    def implicit(params: Mapping[str, torch.Tensor], batch) -> tuple:
        grads, loss, aux = local(params, batch)
        grads, loss = sync(grads, loss)
        return grads, loss, aux

    implicit.local = local
    implicit.sync = sync
    return implicit
