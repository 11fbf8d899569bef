"""Flash attention: causal attention over ``[B, L, H, D]`` with the ``[L, L]``
score matrix never in device memory, forward and backward.

Counterpart of ``autodist_tpu/ops/flash_attention.py``. Four hand-written
Hopper kernels (``csrc/flash_attention.cu``), one per Pallas kernel of the
JAX package, each behind a wrapper that counts its launches:

- :func:`flash_fwd` (replaces ``_flash_kernel``): ``out`` and the per-row
  logsumexp ``lse``;
- :func:`flash_fwd_carry` (replaces ``_flash_carry_kernel``): the same walk
  with the online-softmax state ``(acc, m, l)`` carried in and out
  unnormalized, ring attention's local step
  (:func:`flash_attention_with_carry`);
- :func:`flash_bwd_dkdv` (replaces ``_flash_bwd_dkdv_kernel``): dK and dV,
  with p and ds recomputed per block from the saved lse;
- :func:`flash_bwd_dq` (replaces ``_flash_bwd_dq_kernel``): dQ.

Each kernel is instantiated at head widths 64 and 128
(:data:`KERNEL_HEAD_DIMS`); the two instantiations count their launches
apart: a wrapper's ``launches`` counts its hd-64 kernel, and its
``hd128.launches`` (:data:`KERNELS_HD128`) the hd-128 one.

The row term ``D_i = rowsum(dO * O)`` is plain torch
(:func:`prepare_backward_q_side`), as it is XLA in the JAX package.

A wrapper given CPU tensors computes the kernels' plain versions
(:func:`flash_forward_plain`, :func:`flash_forward_carry_plain`,
:func:`flash_backward_plain`); given CUDA
tensors it launches the kernel or raises, with no fallback. The kernels take
bf16 q/k/v read in place as ``[B, L, H, D]``, D 64 or 128; lse and D are plain f32
``[B * H, Lq]`` (the TPU's ``[bh, n_q, bq]`` planes and 128-lane scratch are
VMEM layout machinery and have no counterpart here). The carry keeps the JAX
layout: acc f32 ``[B, H, Lq, D]``, m and l f32 ``[B, H, Lq]``, the layout of
:func:`autodist_tpu_torch.ops.blockwise_attention.blockwise_attention_with_carry`,
so ``finalize`` takes either.

The global offsets ``q_offset``/``k_offset`` and the backward's ``out_dtype``
override serve ring attention, whose backward reuses the two backward kernels
with f32 outputs.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from autodist_tpu_torch.ops import _build, costs
from autodist_tpu_torch.ops.blockwise_attention import NEG_INF

# Keys per step of the plain versions: bounds their [B, H, Lq, block] f32
# score buffer.
PLAIN_K_BLOCK = 256
# The head widths the kernels are instantiated for (csrc/flash_attention.cu):
# the flagship's d_model 512 over 8 heads, and d_model 1,024 over 8 (the
# width of most public LMs). Other widths are ROADMAP Queue 2 item 2.
KERNEL_HEAD_DIMS = (64, 128)


class LaunchCount:
    """The launch count of one kernel instantiation, read and set to 0 as
    a wrapper's own ``launches`` is (``__name__`` names it)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def _dims(q, k, v) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, L, H, D]")
    b, lq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on B, H or D")
    return b, lq, k.shape[1], h, d


def _invalid(lq, start, stop, causal, q_offset, k_offset, device) -> Optional[torch.Tensor]:
    """``[Lq, stop - start]`` mask of the scores against keys [start, stop),
    or None when nothing is masked."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(lq, device=device)
    k_pos = k_offset + torch.arange(start, stop, device=device)
    return k_pos[None, :] > q_pos[:, None]


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, D]`` -> f32 ``[B, H, L, D]``."""
    return x.transpose(1, 2).float()


# ------------------------------------------------------------ plain versions

def flash_forward_carry_plain(q, k, v, carry=None, causal: bool = True, q_offset: int = 0,
                              k_offset: int = 0, k_block: int = PLAIN_K_BLOCK):
    """Plain version of the carry kernel: the online softmax over key blocks,
    starting from ``carry = (acc, m, l)`` (acc ``[B, H, Lq, D]``, m and l
    ``[B, H, Lq]``, f32) or from nothing, and returning that state
    unnormalized. Products in f32 of the operands as stored, p rounded to v's
    dtype before its product, as in the kernels."""
    b, lq, lk, h, d = _dims(q, k, v)
    scale = 1.0 / (d ** 0.5)
    qt, kt, vt = _heads_first(q), _heads_first(k), _heads_first(v)
    if carry is None:
        acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    else:
        acc = carry[0].float()
        m, l = (x.float()[..., None] for x in carry[1:])
    for start in range(0, lk, k_block):
        stop = min(lk, start + k_block)
        scores = scale * (qt @ kt[:, :, start:stop].transpose(-1, -2))
        invalid = _invalid(lq, start, stop, causal, q_offset, k_offset, q.device)
        if invalid is not None:
            scores = scores.masked_fill(invalid, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_new)
        p = torch.where(scores <= NEG_INF * 0.5, 0.0, torch.exp(scores - m_new))
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + p.to(v.dtype).float() @ vt[:, :, start:stop]
        m = m_new
    return acc, m[..., 0], l[..., 0]


def flash_forward_plain(q, k, v, causal: bool = True, q_offset: int = 0,
                        k_offset: int = 0, k_block: int = PLAIN_K_BLOCK):
    """Plain version of the forward kernel: ``(out, lse)`` with out
    ``[B, Lq, H, D]`` in q's dtype and lse f32 ``[B * H, Lq]``: the carry's
    walk from nothing, normalized."""
    acc, m, l = flash_forward_carry_plain(q, k, v, None, causal, q_offset, k_offset, k_block)
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(l)).reshape(-1, q.shape[1])
    return out, lse


def flash_backward_plain(q, k, v, do, lse, dd, causal: bool = True,
                         q_offset: int = 0, k_offset: int = 0,
                         out_dtype: Optional[torch.dtype] = None,
                         k_block: int = PLAIN_K_BLOCK):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` in
    ``[B, L, H, D]``, p and ds recomputed per key block from the saved lse
    (``[B * H, Lq]``) and ``dd = D_i`` (:func:`prepare_backward_q_side`).
    Outputs take ``out_dtype`` if given, else their input's dtype."""
    b, lq, lk, h, d = _dims(q, k, v)
    scale = 1.0 / (d ** 0.5)
    qt, kt, vt, dot = (_heads_first(x) for x in (q, k, v, do))
    lse4 = lse.float().reshape(b, h, lq, 1)
    dd4 = dd.float().reshape(b, h, lq, 1)
    dq = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    for start in range(0, lk, k_block):
        stop = min(lk, start + k_block)
        k_blk, v_blk = kt[:, :, start:stop], vt[:, :, start:stop]
        p = torch.exp(scale * (qt @ k_blk.transpose(-1, -2)) - lse4)
        invalid = _invalid(lq, start, stop, causal, q_offset, k_offset, q.device)
        if invalid is not None:
            p = p.masked_fill(invalid, 0.0)
        ds = p * (dot @ v_blk.transpose(-1, -2) - dd4)
        dv[:, :, start:stop] = p.to(do.dtype).float().transpose(-1, -2) @ dot
        dk[:, :, start:stop] = scale * (ds.to(q.dtype).float().transpose(-1, -2) @ qt)
        dq += scale * (ds.to(k.dtype).float() @ k_blk)

    def back(x, like):
        return x.transpose(1, 2).to(out_dtype or like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


def prepare_backward_q_side(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The row term ``D_i = rowsum(dO * O)`` in f32 ``[B * H, Lq]``. It depends
    only on the query side, so ring attention computes it once for every
    ring step. (The JAX function also transposes and pads q and dO into its
    kernels' block layout; the kernels here read them in place.)"""
    b, lq, h, _ = o.shape
    dd = (do.float() * o.float()).sum(dim=-1)            # [B, Lq, H]
    return dd.transpose(1, 2).reshape(b * h, lq).contiguous()


# ------------------------------------------------------------------- kernels

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.flash_fwd_carry.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.flash_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.flash_fwd_smem_bytes.argtypes = [i]
    for fn in (lib.flash_fwd, lib.flash_fwd_carry, lib.flash_bwd_dkdv, lib.flash_bwd_dq,
               lib.flash_fwd_smem_bytes):
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_args(q, k, v, do=None, lse=None, dd=None):
    """What the kernels take: bf16 q/k/v (and dO like q) with head width 64
    or 128,
    contiguous and 16-byte aligned (every kernel reads q/k/v, and the
    backward dO, through TMA tensor maps, which need it); f32
    ``[B * H, Lq]`` lse and dd; all on q's card."""
    b, lq, lk, h, d = _dims(q, k, v)
    if 0 in (b, lq, lk, h):
        raise ValueError(f"the flash kernels take no empty dimension: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    bf16 = [q, k, v] + ([do] if do is not None else [])
    if any(t.dtype != torch.bfloat16 for t in bf16):
        raise TypeError("the flash kernels take bf16 q, k, v and dO, got "
                        f"{[t.dtype for t in bf16]}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head widths "
                         f"{KERNEL_HEAD_DIMS}, got {d} (other widths: ROADMAP Queue 2 "
                         f"item 2)")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    for t in (lse, dd):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (b * h, lq)):
            raise ValueError(f"lse and dd must be f32 [{b * h}, {lq}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in bf16 + [t for t in (lse, dd) if t is not None]:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash kernel inputs must be contiguous and on one device")
    if any(t.data_ptr() % 16 for t in bf16):
        raise ValueError("the flash kernels copy rows in 16-byte chunks: q, k, v "
                         "and dO must be 16-byte aligned")
    return b, lq, lk, h, d


def _count(wrapper, d: int) -> None:
    """One launch of ``wrapper``'s kernel at head width ``d``."""
    (wrapper if d == 64 else wrapper.hd128).launches += 1


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _out_f32(out_dtype: Optional[torch.dtype]) -> int:
    if out_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"the flash backward kernels write bf16 or f32, got {out_dtype}")
    return int(out_dtype == torch.float32)


def _probe_cost(name: str, q, k, causal: bool, out_bytes: int = 2):
    """:func:`costs.kernel` for one launch of ``name`` on these operands:
    each input read once and each output written once (bf16 q, k, v and dO
    ``[B, L, H, D]``, f32 lse and D ``[B*H, Lq]``, outputs of
    ``out_bytes`` an element, the carry's f32 acc in and out), and the
    tensor-core products over the scores attended (the causal half, or all
    of them): 2 in the forward and the carry, 4 in dK/dV, 3 in dQ."""
    b, lq, h, d = (int(x) for x in q.shape)
    lk = int(k.shape[1])
    pairs = lq * (lq + 1) / 2 if causal and lq == lk else lq * lk
    product = 2.0 * b * h * pairs * d
    q_act, k_act, row = b * lq * h * d * 2, b * lk * h * d * 2, b * h * lq * 4
    acc = b * h * lq * d * 4
    nbytes, products = {
        "flash_fwd": (2 * q_act + 2 * k_act + row, 2),
        "flash_fwd_carry": (q_act + 2 * k_act + 2 * acc + 4 * row, 2),
        "flash_bwd_dkdv": (2 * q_act + 2 * k_act + 2 * row + k_act * out_bytes, 4),
        "flash_bwd_dq": (2 * q_act + 2 * k_act + 2 * row + q_act * out_bytes // 2, 3),
    }[name]
    return costs.kernel(nbytes, products * product)


def flash_fwd(q, k, v, causal: bool = True, q_offset: int = 0, k_offset: int = 0):
    """``(out, lse)``. CUDA: the forward kernel (replaces ``_flash_kernel``);
    CPU: :func:`flash_forward_plain`."""
    if q.device.type == "cpu":
        with _probe_cost("flash_fwd", q, k, causal):
            return flash_forward_plain(q, k, v, causal, q_offset, k_offset)
    b, lq, lk, h, d = _check_kernel_args(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_lib().flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, lq, lk, d, int(causal), q_offset, k_offset, _stream())
    _count(flash_fwd, d)
    return out, lse


def _check_carry(carry, b, h, lq, d, device):
    """What the carry kernel takes: f32 acc ``[B, H, Lq, D]`` and m, l
    ``[B, H, Lq]``, contiguous and 16-byte aligned, on q's card."""
    shapes = ((b, h, lq, d), (b, h, lq), (b, h, lq))
    for name, t, shape in zip(("acc", "m", "l"), carry, shapes):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"carry {name} must be f32 {list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"carry {name} must be contiguous, 16-byte aligned and on "
                             f"q's device {device}")


def flash_fwd_carry(q, k, v, carry=None, causal: bool = True, q_offset: int = 0,
                    k_offset: int = 0):
    """``(acc, m, l)`` after attending q to k/v from ``carry`` (or from
    nothing). CUDA: the carry kernel (replaces ``_flash_carry_kernel``),
    which writes a fresh carry and leaves the one given unchanged; CPU:
    :func:`flash_forward_carry_plain`."""
    if q.device.type == "cpu":
        with _probe_cost("flash_fwd_carry", q, k, causal):
            return flash_forward_carry_plain(q, k, v, carry, causal, q_offset, k_offset)
    b, lq, lk, h, d = _check_kernel_args(q, k, v)
    if carry is not None:
        _check_carry(carry, b, h, lq, d, q.device)
    acc = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    carry_in = [t.data_ptr() for t in carry] if carry is not None else [None] * 3
    with torch.cuda.device(q.device):
        _launch(_lib().flash_fwd_carry, q.data_ptr(), k.data_ptr(), v.data_ptr(), *carry_in,
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, lq, lk, d, int(causal),
                q_offset, k_offset, _stream())
    _count(flash_fwd_carry, d)
    return acc, m, l


def flash_bwd_dkdv(q, k, v, do, lse, dd, causal: bool = True, q_offset: int = 0,
                   k_offset: int = 0, out_dtype: Optional[torch.dtype] = None):
    """``(dk, dv)``. CUDA: the dK/dV kernel (replaces
    ``_flash_bwd_dkdv_kernel``); CPU: :func:`flash_backward_plain`."""
    if q.device.type == "cpu":
        with _probe_cost("flash_bwd_dkdv", q, k, causal, 4 if out_dtype == torch.float32 else 2):
            return flash_backward_plain(q, k, v, do, lse, dd, causal, q_offset, k_offset,
                                        out_dtype)[1:]
    b, lq, lk, h, d = _check_kernel_args(q, k, v, do, lse, dd)
    f32 = _out_f32(out_dtype)
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_lib().flash_bwd_dkdv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, lq, lk, d, int(causal), q_offset, k_offset, f32,
                _stream())
    _count(flash_bwd_dkdv, d)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, dd, causal: bool = True, q_offset: int = 0,
                 k_offset: int = 0, out_dtype: Optional[torch.dtype] = None):
    """``dq``. CUDA: the dQ kernel (replaces ``_flash_bwd_dq_kernel``); CPU:
    :func:`flash_backward_plain`."""
    if q.device.type == "cpu":
        with _probe_cost("flash_bwd_dq", q, k, causal, 4 if out_dtype == torch.float32 else 2):
            return flash_backward_plain(q, k, v, do, lse, dd, causal, q_offset, k_offset,
                                        out_dtype)[0]
    b, lq, lk, h, d = _check_kernel_args(q, k, v, do, lse, dd)
    f32 = _out_f32(out_dtype)
    dq = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_lib().flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), b, h, lq,
                lk, d, int(causal), q_offset, k_offset, f32, _stream())
    _count(flash_bwd_dq, d)
    return dq


flash_fwd.launches = 0
flash_fwd_carry.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
KERNELS = (flash_fwd, flash_fwd_carry, flash_bwd_dkdv, flash_bwd_dq)
for _k in KERNELS:
    _k.hd128 = LaunchCount(f"{_k.__name__}_hd128")
# The hd-128 instantiations' counts (the wrappers' own count the hd-64 ones).
KERNELS_HD128 = tuple(k.hd128 for k in KERNELS)


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash``: the forward saves (q, k, v, out, lse);
    the backward runs the dK/dV and dQ kernels from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g.contiguous()
        dd = prepare_backward_q_side(out, do)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, dd, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, dd, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention over ``[B, L, H, D]`` tensors, differentiable in q, k
    and v; returns ``[B, Lq, H, D]`` in q's dtype. The JAX signature's
    ``q_block``/``k_block`` are TPU tiling controls (the kernels here size
    their tiles to shared memory and registers: the forward 192 query rows
    a block over 128-key tiles, dQ 192 query rows over 64-key tiles, dK/dV
    128 keys over 64-query tiles) and its ``interpret`` flag a Pallas mode;
    neither has a counterpart."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention_with_carry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               carry=None, *, causal: bool = True, q_offset: int = 0,
                               k_offset: int = 0):
    """Ring attention's local step: ``(acc, m, l)`` carried in and out, acc
    f32 ``[B, H, Lq, D]`` unnormalized and m, l f32 ``[B, H, Lq]``, the
    layout of ``blockwise_attention_with_carry``; normalize with
    ``blockwise_attention.finalize`` after the last step. Not differentiable:
    ring attention's custom backward reuses the backward kernels. As in
    :func:`flash_attention`, the JAX signature's ``q_block``/``k_block`` and
    ``interpret`` have no counterpart."""
    return flash_fwd_carry(q, k, v, carry, causal, q_offset, k_offset)
