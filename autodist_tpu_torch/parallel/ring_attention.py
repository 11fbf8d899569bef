"""Ring attention: sequence (context) parallelism over a process group
(counterpart of ``autodist_tpu/parallel/ring_attention.py``).

Each rank of ``group`` holds one shard of the sequence in ring order (rank r
holds global positions ``[r * L_local, (r + 1) * L_local)``) as its local
``[B, L_local, H, D]`` q/k/v. The K/V shards rotate around the ring, to
rank + 1 and from rank - 1 with ``dist.batch_isend_irecv``, while every
rank accumulates its queries' attention with the online-softmax merge. After
``size`` steps every query has seen every key; each step knows the global
offset of the shard it holds, so the causal mask is global. ``group=None``
is a ring of one rank: no communication.

Two local steps:

- ``impl="flash"`` (and ``"auto"``): the Hopper carry kernel
  (:func:`autodist_tpu_torch.ops.flash_attention.flash_fwd_carry`) chained
  over the ring, inside an ``autograd.Function`` whose backward is the
  second ring pass of the JAX package's custom VJP: dQ accumulates locally,
  and the dK/dV accumulators travel in f32 with their K/V shard and take the
  last hop home. The JAX ``"auto"`` picks blockwise below a local length of
  3,072 (``_FLASH_MIN_LOCAL_LEN``), a crossover measured on a TPU v5e; it is
  not carried over, and ``"auto"`` is always flash here.
- ``impl="blockwise"``: :func:`blockwise_attention_with_carry`, which
  autograd differentiates, with the rotation a differentiable shift whose
  backward sends the gradient the other way. It is the reference semantics
  the flash ring is held to.

``block_size`` is the blockwise key block; the flash kernels tile by 64 and
ignore it, as :func:`~autodist_tpu_torch.ops.flash_attention.flash_attention`
documents for ``q_block``.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch.ops.blockwise_attention import (NEG_INF, blockwise_attention_with_carry,
                                                        finalize)
from autodist_tpu_torch.ops.flash_attention import (flash_bwd, flash_fwd_carry,
                                                    prepare_backward_q_side)

_IMPLS = ("auto", "flash", "blockwise")


def ring_size_and_rank(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """``(size, rank)`` of ``group``; ``(1, 0)`` for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def shift(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
          backward: bool = False, wrap: bool = True) -> List[torch.Tensor]:
    """Each tensor sent one hop around the ring (to rank + 1, from rank - 1;
    the other way with ``backward``), as fresh tensors. A ring of one
    returns them as they are. Without ``wrap`` the hop is a line: the last
    rank (the first with ``backward``) sends nothing and the first receives
    zeros, as ``lax.ppermute`` gives a rank that no pair names."""
    size, rank = ring_size_and_rank(group)
    if size == 1:
        return list(tensors) if wrap else [torch.zeros_like(t) for t in tensors]
    step = -1 if backward else 1
    sends = wrap or 0 <= rank + step < size
    receives = wrap or 0 <= rank - step < size
    to = dist.get_global_rank(group, (rank + step) % size)
    frm = dist.get_global_rank(group, (rank - step) % size)
    received = [torch.empty_like(t, memory_format=torch.contiguous_format) if receives
                else torch.zeros_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        if sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group))
        if receives:
            ops.append(dist.P2POp(dist.irecv, r, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def _ring_loop(group, causal: bool, rotating, carry, body: Callable, rotate: Callable):
    """The ring schedule shared by the forward and backward passes
    (``ring_attention.py:88-117``). ``body(src, rotating, carry) ->
    (rotating, carry)`` runs the local work against the shard that started
    on rank ``src``. Under a causal mask a step whose shard lies wholly in
    the future is skipped, but the ring still rotates, so every rank makes
    the same sends. ``rotate(rotating, carry) -> (rotating, carry)`` is one
    hop; the last step does not rotate."""
    size, rank = ring_size_and_rank(group)
    for step in range(size):
        src = (rank - step) % size
        # Step 0 is this rank's own shard (src == rank): never skipped.
        if step == 0 or not causal or src <= rank:
            rotating, carry = body(src, rotating, carry)
        if step != size - 1:
            rotating, carry = rotate(rotating, carry)
    return rotating, carry


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, group: Optional[dist.ProcessGroup] = None,
                   block_size: int = 512, impl: str = "auto") -> torch.Tensor:
    """Attention of this rank's query shard against the whole sequence, K/V
    rotating around ``group``'s ring. q/k/v: ``[B, L_local, H, D]``, the
    same L_local on every rank; returns ``[B, L_local, H, D]`` in q's dtype,
    differentiable in q, k and v. Every rank of the group must call it
    together."""
    if impl not in _IMPLS:
        raise ValueError(f"Unknown ring attention impl {impl!r}; valid: {_IMPLS}")
    if impl in ("auto", "flash"):
        return _RingFlash.apply(q, k, v, causal, group)
    return _ring_blockwise(q, k, v, causal, group, block_size)


# ------------------------------------------------------------ blockwise step

class _ShiftThrough(torch.autograd.Function):
    """One differentiable hop of the rotating K/V, with the carry passed
    through unchanged. Threading the carry makes every hop reachable from
    the loss on every rank: a rank whose causal steps skip the shards it
    receives still runs each hop's backward, so the neighbours' sends of the
    gradient always find their receive."""

    @staticmethod
    def forward(ctx, group, n_rotating, *tensors):
        ctx.group, ctx.n = group, n_rotating
        moved = shift(tensors[:n_rotating], group)
        return (*moved, *(t.view_as(t) for t in tensors[n_rotating:]))

    @staticmethod
    def backward(ctx, *grads):
        back = shift([g.contiguous() for g in grads[:ctx.n]], ctx.group, backward=True)
        return (None, None, *back, *grads[ctx.n:])


def _ring_blockwise(q, k, v, causal, group, block_size):
    b, l_local, h, d = q.shape
    _, rank = ring_size_and_rank(group)

    def attend(src, kv, carry):
        return kv, blockwise_attention_with_carry(
            q, kv[0], kv[1], carry, causal=causal, block_size=block_size,
            q_offset=rank * l_local, k_offset=src * l_local)

    def rotate(kv, carry):
        out = _ShiftThrough.apply(group, len(kv), *kv, *carry)
        return out[:len(kv)], out[len(kv):]

    carry0 = (torch.zeros((b, h, l_local, d), dtype=torch.float32, device=q.device),
              torch.full((b, h, l_local), NEG_INF, dtype=torch.float32, device=q.device),
              torch.zeros((b, h, l_local), dtype=torch.float32, device=q.device))
    _, carry = _ring_loop(group, causal, (k, v), carry0, attend, rotate)
    return finalize(*carry).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------- flash step

def _plain_rotate(group):
    def rotate(rotating, carry):
        return shift(rotating, group), carry
    return rotate


class _RingFlash(torch.autograd.Function):
    """The flash ring with its two-pass custom backward
    (``ring_attention.py:120-199``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, group):
        b, l_local, h, _ = q.shape
        _, rank = ring_size_and_rank(group)
        q_offset = rank * l_local

        def attend(src, kv, carry):
            return kv, flash_fwd_carry(q, kv[0], kv[1], carry, causal, q_offset,
                                       src * l_local)

        # Step 0 always runs, so the carry is set from then on.
        _, (acc, m, l) = _ring_loop(group, causal, (k, v), None, attend, _plain_rotate(group))
        out = finalize(acc, m, l).transpose(1, 2).to(q.dtype,
                                                     memory_format=torch.contiguous_format)
        lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(b * h, l_local)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.group = causal, group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, group = ctx.causal, ctx.group
        l_local = q.shape[1]
        _, rank = ring_size_and_rank(group)
        q_offset = rank * l_local
        do = g.contiguous()
        # The row term depends only on the query side: once for every step.
        dd = prepare_backward_q_side(out, do)
        f32 = torch.float32

        def step(src, rotating, dq):
            k_cur, v_cur, dk_acc, dv_acc = rotating
            # f32 outputs: the per-step parts add up without a bf16 rounding each.
            k_offset = src * l_local
            dq_part, dk, dv = flash_bwd(q, k_cur, v_cur, do, lse, dd, causal, q_offset,
                                        k_offset, out_dtype=f32)
            if dq is None:      # step 0, which always runs, starts the sums
                return (k_cur, v_cur, dk, dv), dq_part
            return (k_cur, v_cur, dk_acc.add_(dk), dv_acc.add_(dv)), dq.add_(dq_part)

        (_, _, dk, dv), dq = _ring_loop(group, causal, (k, v, None, None), None, step,
                                        _plain_rotate(group))
        # After size - 1 hops the accumulators are one hop short of home.
        dk, dv = shift((dk, dv), group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None
