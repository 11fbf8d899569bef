"""Gradient synchronization (``autodist_tpu/parallel/synchronization.py:165-223``).

Ported so far: the *implicit* lowering at one data replica, where the
gradient of the loss is the synchronized gradient and ``backward`` is all
there is to do, and its sequence-parallel form: with a ``seq`` axis of k > 1
each rank's loss is its shard's share of the global token mean, and the
gradients are summed over the seq group after ``autograd.grad``, the torch
form of the ``psum`` transpose in ``autodist_tpu/parallel/sequence.py:67-70``.
Data parallelism over more than one replica (the NCCL all-reduce over the
data axes) and gradient compression raise ``NotImplementedError``.
"""

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.plan import ShardingPlan

DP_ROADMAP = ("data parallelism over more than one replica is not ported yet "
              "(ROADMAP.md, port queue: dp > 1, the implicit all-reduce)")


def make_grad_fn(sharding_plan: ShardingPlan, model_spec: ModelSpec, dp: int,
                 loss_fn: Callable, seq_group: Optional[dist.ProcessGroup] = None
                 ) -> Callable:
    """``grad_fn(params, batch) -> (grads, loss)``: ``params`` maps
    state-dict keys to leaf tensors that require grad, ``grads`` maps the same
    keys to their gradients, ``loss`` is the detached scalar loss. With a
    ``seq`` axis of k > 1, ``seq_group`` is the group of its k ranks."""
    if dp > 1:
        raise NotImplementedError(DP_ROADMAP)
    if sharding_plan.has_compression:
        raise NotImplementedError("gradient compression is not ported yet")
    seq = sharding_plan.seq_size
    if seq > 1 and (seq_group is None or dist.get_world_size(seq_group) != seq):
        raise RuntimeError(f"the mesh's seq axis has {seq} ranks but the seq group has "
                           f"{1 if seq_group is None else dist.get_world_size(seq_group)}: "
                           f"join the process group first (torchrun)")
    keys = [model_spec.keys[n] for n in model_spec.trainable]

    def implicit(params: Mapping[str, torch.Tensor], batch) -> tuple:
        loss = loss_fn(params, batch)
        # An unused parameter gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        if seq > 1:
            grads = _sum_over(grads, seq_group)
        grads: Dict[str, torch.Tensor] = dict(zip(keys, grads))
        return grads, loss.detach()

    return implicit


def _sum_over(grads, group):
    """Every gradient summed over ``group``, in one all-reduce of a flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]
