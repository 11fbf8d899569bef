"""Helpers shared by the port's models (``autodist_tpu/models/common.py``).

- The LM head (``:62-88``): one definition of which parameter is the head
  table and in which layout: untied, ``lm_head.kernel`` ``[D, V]`` (layout
  ``"dv"``); tied, ``embed.embedding`` ``[V, D]`` (layout ``"vd"``).
- The CNN zoo's ``num_groups`` (``:20-27``) and classification loss
  (``:91-99``).

``params`` is the flat ``{state-dict key: tensor}`` dict the models are
applied with.
"""

from typing import Callable

import torch

from autodist_tpu_torch.models.layers import apply
from autodist_tpu_torch.ops.fused_xent import fused_softmax_xent

HEAD_KERNEL = "lm_head.kernel"
EMBEDDING = "embed.embedding"


def lm_head_logits(h: torch.Tensor, params, tied: bool = False) -> torch.Tensor:
    """``[..., D]`` hidden -> ``[..., V]`` logits, the table cast to the
    activation dtype as the flax head does."""
    if tied:
        return h @ params[EMBEDDING].to(h.dtype).T
    return h @ params[HEAD_KERNEL].to(h.dtype)


def fused_lm_head_nll(h: torch.Tensor, params, targets: torch.Tensor,
                      tied: bool = False) -> torch.Tensor:
    """Per-token f32 NLL ``[B, T]`` through the fused head and loss: the
    ``[B*T, V]`` logits never exist in memory."""
    h2 = h.reshape(-1, h.shape[-1])
    if tied:
        nll = fused_softmax_xent(h2, params[EMBEDDING], targets.reshape(-1),
                                 w_layout="vd")
    else:
        nll = fused_softmax_xent(h2, params[HEAD_KERNEL], targets.reshape(-1))
    return nll.reshape(targets.shape)


def num_groups(channels: int, max_groups: int) -> int:
    """Largest GroupNorm group count <= max_groups that divides the channel
    count (CNN widths like 80/48/76 are not multiples of the usual 32)."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def make_classification_loss_fn(model) -> Callable:
    """Softmax cross entropy over ``{"images": NHWC, "labels": int}``
    batches: the mean NLL of the f32 log-softmax of ``model``'s logits."""

    def loss_fn(params, batch):
        logits = apply(model, params, batch["images"])
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -logprobs.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()

    return loss_fn
