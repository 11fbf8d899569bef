"""Ulysses sequence parallelism: attention by two all-to-alls around flash
(counterpart of ``autodist_tpu/parallel/ulysses.py``).

The second sequence-parallel scheme beside ring attention: each rank of the
seq group holds one shard of the sequence, ``[B, L/s, H, D]``. One
all-to-all re-shards q, k and v by heads, ``[B, L, H/s, D]``: rank j
receives heads ``[j H/s, (j + 1) H/s)`` of the whole sequence, the shards
concatenated in rank order (the JAX package's ``tiled=True``). Each rank then
runs plain causal flash attention over the whole sequence
(:func:`autodist_tpu_torch.ops.flash_attention.flash_attention`, the Hopper
forward, dK/dV and dQ kernels on the card), masking by global position with
no offsets, and a second all-to-all restores the sequence sharding.

``dist.all_to_all_single`` splits dim 0 only, so each exchange moves the
split axis to the front, exchanges, and moves the axes back. c10d's
collective has no gradient: the exchange is an ``autograd.Function`` whose
backward is the inverse all-to-all (split and concat axes swapped).
"""

from typing import Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.parallel.ring_attention import ring_size_and_rank


def all_to_all(x: torch.Tensor, group: dist.ProcessGroup, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group``: chunk j of ``split_axis`` goes to rank j, and the chunks
    received are concatenated along ``concat_axis`` in rank order."""
    size, _ = ring_size_and_rank(group)
    moved = x.movedim(split_axis, 0)
    send = moved.reshape(size, moved.shape[0] // size, *moved.shape[1:]).contiguous()
    received = torch.empty_like(send)
    dist.all_to_all_single(received, send, group=group)
    # [rank, chunk, others...] -> the chunk back at split_axis, the rank just
    # before concat_axis, then the two merged rank-major.
    out = received.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= size
    shape[concat_axis] *= size
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return all_to_all(g, ctx.group, concat_axis, split_axis), None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Attention over this rank's sequence shard ``[B, L/s, H, D]`` of q, k
    and v (shards in rank order over ``group``'s s ranks), by head
    re-sharding; returns this rank's shard of the output, differentiable in
    q, k and v. Every rank of the group calls it together. ``group=None``
    (s = 1) is flash attention itself. Needs ``H`` divisible by s."""
    size, _ = ring_size_and_rank(group)
    if size == 1:
        return flash_attention(q, k, v, causal=causal)
    n_heads = q.shape[2]
    if n_heads % size:
        raise ValueError(
            f"Ulysses attention needs n_heads ({n_heads}) divisible by the seq "
            f"axis ({size}); use ring attention otherwise")
    qh, kh, vh = (_AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal)       # whole L, H/s heads
    return _AllToAll.apply(out, group, 1, 2)


def make_ulysses_attention_fn(mesh, *, causal: bool = True):
    """:func:`ulysses_attention` over ``mesh``'s seq group, on this rank's
    rows and sequence shard (the port's counterpart of the JAX shard_map
    wrapper over (data, seq))."""
    group = mesh.group((const.MESH_AXIS_SEQ,))

    def fn(q, k, v):
        return ulysses_attention(q, k, v, causal=causal, group=group)

    return fn
