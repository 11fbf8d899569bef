"""Blockwise (memory-efficient) attention in plain PyTorch
(counterpart of ``autodist_tpu/ops/blockwise_attention.py``).

Online-softmax attention over key/value blocks, all in f32 over
``[B, L, H, D]`` tensors: peak memory is O(L * block) instead of O(L^2), and
autograd differentiates the loop. It is the reference semantics of the flash
kernels (:mod:`autodist_tpu_torch.ops.flash_attention`) and the model's
``attention_impl="blockwise"`` path; its carry form is ring attention's local
step (the online-softmax merge is the ring accumulation rule).
"""

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _merge(acc, m, l, scores, v_blk):
    """One online-softmax update (all f32).

    acc: ``[..., q, d]`` unnormalized output; m: ``[..., q]`` running max;
    l: ``[..., q]`` running denominator; scores: ``[..., q, k]``;
    v_blk: ``[..., k, d]``.
    """
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    # Zero fully-masked entries explicitly: when a whole row is masked both
    # scores and m_new sit at NEG_INF and exp(0) = 1 would poison the denominator.
    p = torch.where(scores <= NEG_INF * 0.5, torch.zeros((), dtype=scores.dtype,
                                                         device=scores.device),
                    torch.exp(scores - m_new[..., None]))
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + p @ v_blk
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, *, causal: bool = True, block_size: int = 256,
                        q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention. q/k/v: ``[B, L, H, D]`` (L may differ for q
    and k/v); returns ``[B, Lq, H, D]`` in q's dtype.

    ``q_offset``/``k_offset`` are the global positions of the first query/key:
    ring attention passes the ring-shifted key offset so causal masking stays
    globally correct.
    """
    acc, m, l = _blockwise_inner(q, k, v, causal, block_size, q_offset, k_offset,
                                 init_carry=None)
    out = finalize(acc, m, l)                       # [B, H, Lq, D]
    return out.transpose(1, 2).to(q.dtype)


def blockwise_attention_with_carry(q, k, v, carry, *, causal: bool = True,
                                   block_size: int = 256, q_offset: int = 0,
                                   k_offset: int = 0):
    """Ring-attention building block: the same loop, accepting and returning
    the ``(acc, m, l)`` carry (acc ``[B, H, Lq, D]``, m/l ``[B, H, Lq]``, f32)
    so partial results merge across ring steps. Normalize with
    :func:`finalize` after the last step."""
    return _blockwise_inner(q, k, v, causal, block_size, q_offset, k_offset,
                            init_carry=carry)


def finalize(acc, m, l):
    """Normalize an online-softmax carry into the attention output."""
    del m
    safe_l = torch.clamp(l, min=1e-30)
    return acc / safe_l[..., None]


def _blockwise_inner(q, k, v, causal, block_size, q_offset, k_offset,
                     init_carry: Optional[Tuple[torch.Tensor, ...]]):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / (d ** 0.5)

    # [B, H, L, D] in f32 for the accumulation.
    qt = q.transpose(1, 2).float() * scale
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()

    if init_carry is None:
        acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    else:
        acc, m, l = init_carry

    block = min(block_size, lk)
    q_pos = q_offset + torch.arange(lq, device=q.device)
    for start in range(0, lk, block):
        k_blk = kt[:, :, start:start + block]
        v_blk = vt[:, :, start:start + block]
        scores = qt @ k_blk.transpose(-1, -2)                 # [B, H, Lq, blk]
        if causal:
            k_pos = k_offset + start + torch.arange(k_blk.shape[2], device=q.device)
            invalid = k_pos[None, :] > q_pos[:, None]
            scores = scores.masked_fill(invalid, NEG_INF)
        acc, m, l = _merge(acc, m, l, scores, v_blk)
    return acc, m, l
