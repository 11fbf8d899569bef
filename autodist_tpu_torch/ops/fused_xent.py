"""Fused LM-head softmax cross-entropy: the loss's logsumexp and its gradient
without the ``[N, V]`` logits in device memory.

Counterpart of ``autodist_tpu/ops/fused_xent.py``. The separable form of the
LM loss is ``nll_n = lse_n - true_logit_n`` with
``lse_n = logsumexp_v(h_n . w_v + b_v)``. The lse term and its VJP run in
three hand-written Hopper kernels (``csrc/fused_xent.cu``), one per Pallas
kernel of the JAX package; the true-logit term is a cheap gather left to
plain torch, as the JAX package leaves it to XLA.

``w`` is taken in either layout, ``[D, V]`` (``w_layout="dv"``, a dense
kernel) or ``[V, D]`` (``"vd"``, an embedding table), and in its stored dtype.
The forward and dh kernels read it as packed by a fourth kernel
(:func:`xent_pack_w`): rounded to bf16 once a call, in the stored layout,
``"dv"`` rows padded to :func:`packed_cols` columns; the dw/db kernel casts
it per tile. ``dw`` comes back in the stored layout and dtype.

Each kernel has a wrapper (:func:`xent_fwd`, :func:`xent_dh`,
:func:`xent_dwdb`, :func:`xent_pack_w`) that counts its launches in a
``launches`` attribute. A wrapper given CPU tensors computes the kernel's
plain version (:func:`matmul_logsumexp_plain`, :func:`lse_backward_plain`,
:func:`pack_w_plain`); given CUDA tensors it launches the kernel or raises,
with no fallback.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from autodist_tpu_torch.ops import _build

# Vocab columns per step of the plain versions: bounds their [N, chunk] f32
# logits buffer.
PLAIN_V_CHUNK = 4096
# The only model width the kernels are instantiated for (csrc/fused_xent.cu).
KERNEL_D = 512
# The packed "dv" table's rows are padded to a multiple of this many columns:
# TMA reads rows whose byte stride is a multiple of 16.
PACK_COLS = 8


def _w_vd(w_layout: str) -> bool:
    if w_layout not in ("dv", "vd"):
        raise ValueError(f"w_layout must be 'dv' or 'vd', got {w_layout!r}")
    return w_layout == "vd"


def _dims(h, w, vd: bool) -> Tuple[int, int, int]:
    n, d = h.shape
    dw, v = (w.shape[1], w.shape[0]) if vd else tuple(w.shape)
    if dw != d:
        raise ValueError(f"h is [N, {d}] but w ({'vd' if vd else 'dv'}) is "
                         f"{tuple(w.shape)}")
    return n, d, v


# ------------------------------------------------------------ plain versions

def _w_chunk(w, vd: bool, v0: int, v1: int, dtype) -> torch.Tensor:
    """``[D, c]`` f32 slice of w holding its values rounded to the activation
    dtype: the kernels' per-tile cast, with products then taken in f32."""
    wc = w[v0:v1].T if vd else w[:, v0:v1]
    return wc.to(dtype).float()


def _logits_chunk(hf, w, b, vd, v0, v1, dtype):
    wc = _w_chunk(w, vd, v0, v1, dtype)
    logits = hf @ wc
    if b is not None:
        logits = logits + b[v0:v1]
    return logits, wc


def packed_cols(v: int) -> int:
    """Columns of the packed ``"dv"`` table: ``v`` rounded up to
    :data:`PACK_COLS` (``packed_cols`` in ``csrc/fused_xent.cu``)."""
    return -(-v // PACK_COLS) * PACK_COLS


def pack_w_plain(w, w_layout: str = "dv") -> torch.Tensor:
    """Plain version of the pack kernel: w rounded to bf16 in its stored
    layout; ``"dv"`` rows padded with zeros to :func:`packed_cols` columns."""
    wp = w.to(torch.bfloat16)
    if _w_vd(w_layout):
        return wp.contiguous()
    return torch.nn.functional.pad(wp, (0, packed_cols(w.shape[1]) - w.shape[1])).contiguous()


def matmul_logsumexp_plain(h, w, b=None, w_layout: str = "dv",
                           v_chunk: int = PLAIN_V_CHUNK) -> torch.Tensor:
    """Plain version of the forward kernel: f32 ``[N]``
    ``logsumexp(h @ w + b)`` over vocab chunks, merged with a running
    logsumexp, so only an ``[N, v_chunk]`` logits buffer exists at a time."""
    vd = _w_vd(w_layout)
    n, _, v = _dims(h, w, vd)
    hf = h.float()
    lse = torch.full((n,), float("-inf"), dtype=torch.float32, device=h.device)
    for v0 in range(0, v, v_chunk):
        logits, _ = _logits_chunk(hf, w, b, vd, v0, min(v, v0 + v_chunk), h.dtype)
        lse = torch.logaddexp(lse, torch.logsumexp(logits, dim=-1))
    return lse


def lse_backward_plain(h, w, b, lse, g, w_layout: str = "dv",
                       v_chunk: int = PLAIN_V_CHUNK):
    """Plain version of the two backward kernels: ``(dh, dw, db)`` of
    ``sum(g * lse)``, the logits recomputed per vocab chunk from the saved
    lse. ``g * softmax`` is rounded to the activation dtype before its
    products, as in the kernels; dh comes back in h's dtype, dw in w's layout
    and dtype, db in f32."""
    vd = _w_vd(w_layout)
    n, d, v = _dims(h, w, vd)
    hf = h.float()
    g = g.float()
    dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    db = torch.empty((v,), dtype=torch.float32, device=h.device)
    for v0 in range(0, v, v_chunk):
        v1 = min(v, v0 + v_chunk)
        logits, wc = _logits_chunk(hf, w, b, vd, v0, v1, h.dtype)
        p = torch.exp(logits - lse[:, None]) * g[:, None]
        db[v0:v1] = p.sum(dim=0)
        ph = p.to(h.dtype).float()
        dh += ph @ wc.T
        dwc = (hf.T @ ph).to(w.dtype)                       # [D, c]
        if vd:
            dw[v0:v1] = dwc.T
        else:
            dw[:, v0:v1] = dwc
    return dh.to(h.dtype), dw, db


# ------------------------------------------------------------------- kernels

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_xent")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.xent_pack_w.argtypes = [p, p, i, i, i, p]
    lib.xent_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.xent_dh.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.xent_dwdb.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    for fn in (lib.xent_pack_w, lib.xent_fwd, lib.xent_dh, lib.xent_dwdb):
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_args(h, w, b, vd: bool, *vectors) -> Tuple[int, int, int]:
    """What the kernels take: bf16 ``h [N, 512]`` (16-byte aligned), f32 ``w``
    in either layout, optional f32 ``b [V]`` (8-byte aligned), f32 ``[N]``
    vectors; all contiguous, on h's card."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError("h and w must be 2-D")
    n, d, v = _dims(h, w, vd)
    if h.dtype != torch.bfloat16:
        raise TypeError(f"the fused-xent kernels take bf16 h, got {h.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"the fused-xent kernels take an f32 table, got {w.dtype}")
    if d != KERNEL_D:
        raise ValueError(f"the fused-xent kernels are built for D = {KERNEL_D}, "
                         f"got D = {d}")
    if b is not None and (b.dtype != torch.float32 or tuple(b.shape) != (v,)):
        raise ValueError(f"b must be f32 [{v}], got {b.dtype} {tuple(b.shape)}")
    for t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"lse and g must be f32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (h, w, b, *vectors):
        if t is not None and (t.device != h.device or not t.is_contiguous()):
            raise ValueError("fused-xent kernel inputs must be contiguous and "
                             "on one device")
    if h.data_ptr() % 16:
        raise ValueError("the fused-xent kernels copy h in 16-byte chunks: its "
                         "data must be 16-byte aligned")
    if b is not None and b.data_ptr() % 8:
        raise ValueError("the fused-xent kernels read b two columns at a time: its "
                         "data must be 8-byte aligned")
    return n, d, v


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def xent_pack_w(w, w_layout: str = "dv") -> torch.Tensor:
    """w as the forward and dh kernels read it: bf16 in its stored layout,
    ``"dv"`` rows padded with zeros to :func:`packed_cols` columns. CUDA: the
    pack kernel (no TPU counterpart: the Pallas kernels cast each block in
    VMEM); CPU: :func:`pack_w_plain`."""
    vd = _w_vd(w_layout)
    if w.device.type == "cpu":
        return pack_w_plain(w, w_layout)
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"the pack kernel takes a contiguous f32 2-D table, got "
                         f"{w.dtype} {tuple(w.shape)}")
    v, d = tuple(w.shape) if vd else tuple(w.shape[::-1])
    if d != KERNEL_D:
        raise ValueError(f"the fused-xent kernels are built for D = {KERNEL_D}, "
                         f"got D = {d}")
    shape = (v, d) if vd else (d, packed_cols(v))
    wp = torch.empty(shape, dtype=torch.bfloat16, device=w.device)
    with torch.cuda.device(w.device):
        _launch(_lib().xent_pack_w, _ptr(w), _ptr(wp), d, v, int(vd),
                torch.cuda.current_stream().cuda_stream)
    xent_pack_w.launches += 1
    return wp


def xent_fwd(h, w, b, w_layout: str = "dv") -> torch.Tensor:
    """f32 ``[N]`` ``logsumexp(h @ w + b)``. CUDA: the pack, then the
    forward kernel (replaces ``_fwd_kernel``); CPU:
    :func:`matmul_logsumexp_plain`."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        return matmul_logsumexp_plain(h, w, b, w_layout)
    n, d, v = _check_kernel_args(h, w, b, vd)
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    if n:
        wp = xent_pack_w(w, w_layout)
        with torch.cuda.device(h.device):
            _launch(_lib().xent_fwd, _ptr(h), _ptr(wp), _ptr(b), _ptr(lse), n, d, v,
                    int(vd), torch.cuda.current_stream().cuda_stream)
        xent_fwd.launches += 1
    return lse


def xent_dh(h, w, b, lse, g, w_layout: str = "dv") -> torch.Tensor:
    """``dh`` of ``sum(g * lse)`` in h's dtype. CUDA: the pack, then the dh
    kernel (replaces ``_dh_kernel``); CPU: :func:`lse_backward_plain`."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        return lse_backward_plain(h, w, b, lse, g, w_layout)[0]
    n, d, v = _check_kernel_args(h, w, b, vd, lse, g)
    dh = torch.empty((n, d), dtype=h.dtype, device=h.device)
    if n:
        wp = xent_pack_w(w, w_layout)
        with torch.cuda.device(h.device):
            _launch(_lib().xent_dh, _ptr(h), _ptr(wp), _ptr(b), _ptr(lse), _ptr(g),
                    _ptr(dh), n, d, v, int(vd),
                    torch.cuda.current_stream().cuda_stream)
        xent_dh.launches += 1
    return dh


def xent_dwdb(h, w, b, lse, g, w_layout: str = "dv"):
    """``(dw, db)`` of ``sum(g * lse)``: dw in w's layout and dtype, db f32
    ``[V]``. CUDA: the dw/db kernel (replaces ``_dwdb_kernel``); CPU:
    :func:`lse_backward_plain`."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        return lse_backward_plain(h, w, b, lse, g, w_layout)[1:]
    n, d, v = _check_kernel_args(h, w, b, vd, lse, g)
    if n == 0:
        return torch.zeros_like(w), torch.zeros((v,), dtype=torch.float32,
                                                device=h.device)
    dw = torch.empty_like(w)
    db = torch.empty((v,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        _launch(_lib().xent_dwdb, _ptr(h), _ptr(w), _ptr(b), _ptr(lse), _ptr(g),
                _ptr(dw), _ptr(db), n, d, v, int(vd),
                torch.cuda.current_stream().cuda_stream)
    xent_dwdb.launches += 1
    return dw, db


xent_pack_w.launches = 0
xent_fwd.launches = 0
xent_dh.launches = 0
xent_dwdb.launches = 0
# The kernels that replace a TPU kernel; the pack runs beside them.
KERNELS = (xent_fwd, xent_dh, xent_dwdb)


class _MatmulLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, w_layout):
        lse = xent_fwd(h, w, b, w_layout)
        ctx.save_for_backward(h, w, b, lse)
        ctx.w_layout = w_layout
        return lse

    @staticmethod
    def backward(ctx, g):
        h, w, b, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = xent_dh(h, w, b, lse, g, ctx.w_layout)
        dw, db = xent_dwdb(h, w, b, lse, g, ctx.w_layout)
        return dh, dw, (db if b is not None else None), None


def matmul_logsumexp(h, w, b=None, w_layout: str = "dv") -> torch.Tensor:
    """``logsumexp(h @ w + b, -1)`` without the logits in memory.

    h: ``[N, D]``; w: ``[D, V]`` (``"dv"``) or ``[V, D]`` (``"vd"``); b: ``[V]``
    or None. Returns f32 ``[N]``, differentiable in h, w and b. The JAX
    signature's block sizes and interpret flag are TPU tiling controls and
    have no counterpart here."""
    return _MatmulLogsumexp.apply(h, w, b, w_layout)


def fused_softmax_xent(h, w, targets, b=None, w_layout: str = "dv") -> torch.Tensor:
    """Per-row NLL of ``targets`` under ``softmax(h @ w + b)``: f32 ``[N]``.
    The lse term runs through the kernels; the true logit is a gather and a
    row dot in plain torch (its gradient is the row-sparse scatter)."""
    lse = matmul_logsumexp(h, w, b, w_layout)
    if _w_vd(w_layout):
        w_true = w.index_select(0, targets)                  # [N, D]
    else:
        w_true = w.index_select(1, targets).T                # [N, D]
    true_logit = (h.float() * w_true.to(h.dtype).float()).sum(dim=-1)
    if b is not None:
        true_logit = true_logit + b[targets]
    return lse - true_logit
