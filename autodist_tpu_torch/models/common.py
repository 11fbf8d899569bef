"""LM-head helpers shared by the port's models (``autodist_tpu/models/common.py:62-88``).

One definition of which parameter is the head table and in which layout:
untied, ``lm_head.kernel`` ``[D, V]`` (layout ``"dv"``); tied,
``embed.embedding`` ``[V, D]`` (layout ``"vd"``). ``params`` is the flat
``{state-dict key: tensor}`` dict the models are applied with.
"""

import torch

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
