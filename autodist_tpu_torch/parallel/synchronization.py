"""Gradient synchronization (``autodist_tpu/parallel/synchronization.py:165-223``).

Ported so far: the *implicit* lowering at one data replica, where the
gradient of the global loss is the synchronized gradient and ``backward``
is all there is to do. Data parallelism over more than one replica (the NCCL
all-reduce) and gradient compression are the next slice's work and raise
``NotImplementedError``.
"""

from typing import Callable, Dict, Mapping

import torch

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.plan import ShardingPlan

DP_ROADMAP = ("data parallelism over more than one replica is not ported yet "
              "(ROADMAP.md, port queue item 1: the implicit all-reduce)")


def make_grad_fn(sharding_plan: ShardingPlan, model_spec: ModelSpec, dp: int,
                 loss_fn: Callable) -> Callable:
    """``grad_fn(params, batch) -> (grads, loss)``: ``params`` maps
    state-dict keys to leaf tensors that require grad, ``grads`` maps the same
    keys to their gradients, ``loss`` is the detached scalar loss."""
    if dp > 1:
        raise NotImplementedError(DP_ROADMAP)
    if sharding_plan.has_compression:
        raise NotImplementedError("gradient compression is not ported yet")
    keys = [model_spec.keys[n] for n in model_spec.trainable]

    def implicit(params: Mapping[str, torch.Tensor], batch) -> tuple:
        loss = loss_fn(params, batch)
        # An unused parameter gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        grads: Dict[str, torch.Tensor] = dict(zip(keys, grads))
        return grads, loss.detach()

    return implicit
