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
All three kernels read it as packed by a fourth kernel
(:func:`xent_pack_w`): rounded to bf16 once a call, in the stored layout,
``"dv"`` rows padded to :func:`packed_cols` columns; the backward packs once
and hands the table to both of its kernels. ``dw`` comes back in the stored
layout and dtype.

The kernels are built for ``D`` in :data:`KERNEL_WIDTHS` (512, 768 and
1,024; another width on the card raises) and take bf16 ``h``. An f32 ``h``
(lm1b's LSTM hands the head f32 states) is rounded to bf16 once a call and
the kernels run on that, with f32 accumulation; ``dh`` comes back in f32.
The plain versions compute in ``h``'s own dtype, so on the CPU an f32 ``h``
gives f32 products throughout, as the JAX kernels do.

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

from autodist_tpu_torch.ops import _build, costs

# Vocab columns per step of the plain versions: bounds their [N, chunk] f32
# logits buffer.
PLAIN_V_CHUNK = 4096
# The model widths the kernels are instantiated for (csrc/fused_xent.cu).
KERNEL_WIDTHS = (512, 768, 1024)
WIDTHS_ROADMAP = "ROADMAP.md, Queue 2 item 1: the fused head at other widths"
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

def _chunks(w, b, vd: bool, v: int, v_chunk: int):
    """``[(v0, v1, w chunk, b chunk or None)]`` over the vocab. The table is
    split, not sliced, so a trace of the loss shows it read whole, as the
    kernels read it (the sparse-parameter walk counts a slice as a gather).
    Columns past ``v`` (a packed table's padding) are left out."""
    dim = 0 if vd else 1
    sizes = [min(v_chunk, v - v0) for v0 in range(0, v, v_chunk)]
    pad = w.shape[dim] - v
    ws = w.split(sizes + ([pad] if pad else []), dim=dim)
    bs = b.split(sizes) if b is not None else [None] * len(sizes)
    return [(v0, v0 + c, wc, bc)
            for v0, c, wc, bc in zip(range(0, v, v_chunk), sizes, ws, bs)]


def _logits_chunk(hf, wc, bc, vd, dtype):
    """Logits of one vocab chunk, and the chunk as ``[D, c]`` f32 holding
    its values rounded to the activation dtype: what the kernels read, with
    products then taken in f32."""
    wc = (wc.T if vd else wc).to(dtype).float()
    logits = hf @ wc
    if bc is not None:
        logits = logits + bc
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
    for _, _, wc, bc in _chunks(w, b, vd, v, v_chunk):
        logits, _ = _logits_chunk(hf, wc, bc, vd, h.dtype)
        lse = torch.logaddexp(lse, torch.logsumexp(logits, dim=-1))
    return lse


def lse_backward_plain(h, w, b, lse, g, w_layout: str = "dv",
                       v_chunk: int = PLAIN_V_CHUNK, wp=None):
    """Plain version of the two backward kernels: ``(dh, dw, db)`` of
    ``sum(g * lse)``, the logits recomputed per vocab chunk from the saved
    lse. ``g * softmax`` is rounded to the activation dtype before its
    products, as in the kernels; dh comes back in h's dtype, dw in w's layout
    and dtype, db in f32. Given ``wp`` (w packed, :func:`pack_w_plain`), the
    products read its values, as the kernels do."""
    vd = _w_vd(w_layout)
    n, d, v = _dims(h, w, vd)
    hf = h.float()
    g = g.float()
    dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    db = torch.empty((v,), dtype=torch.float32, device=h.device)
    table = w if wp is None else wp
    for v0, v1, wc, bc in _chunks(table, b, vd, v, v_chunk):
        logits, wc = _logits_chunk(hf, wc, bc, vd, h.dtype)
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
    lib.xent_dwdb_active_clusters.argtypes = []
    for fn in (lib.xent_pack_w, lib.xent_fwd, lib.xent_dh, lib.xent_dwdb,
               lib.xent_dwdb_active_clusters):
        fn.restype = ctypes.c_int
    return lib


def _check_width(d: int) -> None:
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"the fused-xent kernels are built for D in {KERNEL_WIDTHS}, "
                         f"got D = {d} ({WIDTHS_ROADMAP})")


def kernel_h(h: torch.Tensor) -> torch.Tensor:
    """``h`` as the kernels read it: an f32 ``h`` rounded to bf16 (once a
    call), a bf16 one as it is."""
    return h.to(torch.bfloat16) if h.dtype == torch.float32 else h


def _check_kernel_args(h, w, b, vd: bool, *vectors) -> Tuple[int, int, int]:
    """What the kernels take: bf16 ``h [N, D]`` (D in :data:`KERNEL_WIDTHS`,
    16-byte aligned; see :func:`kernel_h`), f32 ``w`` in either layout,
    optional f32 ``b [V]`` (8-byte aligned), f32 ``[N]`` vectors; all
    contiguous, on h's card."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError("h and w must be 2-D")
    n, d, v = _dims(h, w, vd)
    if h.dtype != torch.bfloat16:
        raise TypeError(f"the fused-xent kernels take bf16 or f32 h, got {h.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"the fused-xent kernels take an f32 table, got {w.dtype}")
    _check_width(d)
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


def _kernel_cost(name: str, n: int, d: int, v: int, bias: bool):
    """``(HBM bytes, tensor-core operations)`` of one launch of ``name`` at
    ``[N, D] x [D, V]``: each input read once, each output written once
    (bf16 h and packed table, f32 lse, g, dw and db), and 2, 4 or 4
    products of ``N D V``; the pack reads the f32 table and writes it bf16."""
    h, wp, vec, b = n * d * 2, d * v * 2, n * 4, v * 4 if bias else 0
    ops = 2.0 * n * d * v
    return {"xent_pack_w": (d * v * 6, 0.0),
            "xent_fwd": (h + wp + b + vec, ops),
            "xent_dh": (h + wp + b + 2 * vec + h, 2 * ops),
            "xent_dwdb": (h + wp + b + 2 * vec + d * v * 4 + v * 4, 2 * ops)}[name]


def _probe_cost(name: str, h, w, b, w_layout: str, packs: int = 0):
    """:func:`costs.kernel` for ``name`` on these operands, with ``packs``
    launches of the pack before it (the plain version runs inside)."""
    n, d, v = _dims(h, w, _w_vd(w_layout))
    nbytes, flops = _kernel_cost(name, n, d, v, b is not None)
    nbytes += packs * _kernel_cost("xent_pack_w", n, d, v, False)[0]
    return costs.kernel(nbytes, flops, 1 + packs)


def xent_pack_w(w, w_layout: str = "dv") -> torch.Tensor:
    """w as the fused-head kernels read it: bf16 in its stored layout,
    ``"dv"`` rows padded with zeros to :func:`packed_cols` columns. CUDA: the
    pack kernel (no TPU counterpart: the Pallas kernels cast each block in
    VMEM); CPU: :func:`pack_w_plain`."""
    vd = _w_vd(w_layout)
    if w.device.type == "cpu":
        v, d = tuple(w.shape) if vd else tuple(w.shape[::-1])
        with costs.kernel(_kernel_cost("xent_pack_w", 0, d, v, False)[0], 0.0):
            return pack_w_plain(w, w_layout)
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"the pack kernel takes a contiguous f32 2-D table, got "
                         f"{w.dtype} {tuple(w.shape)}")
    v, d = tuple(w.shape) if vd else tuple(w.shape[::-1])
    _check_width(d)
    shape = (v, d) if vd else (d, packed_cols(v))
    wp = torch.empty(shape, dtype=torch.bfloat16, device=w.device)
    with torch.cuda.device(w.device):
        _launch(_lib().xent_pack_w, _ptr(w), _ptr(wp), d, v, int(vd),
                torch.cuda.current_stream().cuda_stream)
    xent_pack_w.launches += 1
    return wp


def xent_fwd(h, w, b, w_layout: str = "dv") -> torch.Tensor:
    """f32 ``[N]`` ``logsumexp(h @ w + b)``. CUDA: the pack, then the
    forward kernel (replaces ``_fwd_kernel``) on :func:`kernel_h`'s h; CPU:
    :func:`matmul_logsumexp_plain`."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        with _probe_cost("xent_fwd", h, w, b, w_layout, packs=1):
            return matmul_logsumexp_plain(h, w, b, w_layout)
    h = kernel_h(h)
    n, d, v = _check_kernel_args(h, w, b, vd)
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    if n:
        wp = xent_pack_w(w, w_layout)
        with torch.cuda.device(h.device):
            _launch(_lib().xent_fwd, _ptr(h), _ptr(wp), _ptr(b), _ptr(lse), n, d, v,
                    int(vd), torch.cuda.current_stream().cuda_stream)
        xent_fwd.launches += 1
    return lse


def _packed(w, w_layout: str, wp) -> torch.Tensor:
    """``wp`` if given (checked against w's pack's shape), else a new pack."""
    if wp is None:
        return xent_pack_w(w, w_layout)
    v, d = tuple(w.shape) if _w_vd(w_layout) else tuple(w.shape[::-1])
    shape = (v, d) if _w_vd(w_layout) else (d, packed_cols(v))
    if (wp.dtype != torch.bfloat16 or tuple(wp.shape) != shape or not wp.is_contiguous()
            or wp.device != w.device or wp.data_ptr() % 16):
        raise ValueError(f"wp must be xent_pack_w's table: contiguous bf16 {shape} on "
                         f"w's device, 16-byte aligned; got {wp.dtype} {tuple(wp.shape)}")
    return wp


def xent_dh(h, w, b, lse, g, w_layout: str = "dv", wp=None) -> torch.Tensor:
    """``dh`` of ``sum(g * lse)`` in h's dtype. CUDA: the pack (unless ``wp``,
    :func:`xent_pack_w`'s table of w, is given), then the dh kernel (replaces
    ``_dh_kernel``) on :func:`kernel_h`'s h; CPU: :func:`lse_backward_plain`,
    reading ``wp`` if given."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        with _probe_cost("xent_dh", h, w, b, w_layout, packs=int(wp is None)):
            return lse_backward_plain(h, w, b, lse, g, w_layout, wp=wp)[0]
    dtype, h = h.dtype, kernel_h(h)
    n, d, v = _check_kernel_args(h, w, b, vd, lse, g)
    dh = torch.empty((n, d), dtype=h.dtype, device=h.device)
    if n:
        wp = _packed(w, w_layout, wp)
        with torch.cuda.device(h.device):
            _launch(_lib().xent_dh, _ptr(h), _ptr(wp), _ptr(b), _ptr(lse), _ptr(g),
                    _ptr(dh), n, d, v, int(vd),
                    torch.cuda.current_stream().cuda_stream)
        xent_dh.launches += 1
    return dh.to(dtype)


def xent_dwdb(h, w, b, lse, g, w_layout: str = "dv", wp=None):
    """``(dw, db)`` of ``sum(g * lse)``: dw in w's layout and dtype, db f32
    ``[V]``. CUDA: the pack (unless ``wp`` is given, as for :func:`xent_dh`),
    then the dw/db kernel (replaces ``_dwdb_kernel``); CPU:
    :func:`lse_backward_plain`, reading ``wp`` if given."""
    vd = _w_vd(w_layout)
    if h.device.type == "cpu":
        with _probe_cost("xent_dwdb", h, w, b, w_layout, packs=int(wp is None)):
            return lse_backward_plain(h, w, b, lse, g, w_layout, wp=wp)[1:]
    h = kernel_h(h)
    n, d, v = _check_kernel_args(h, w, b, vd, lse, g)
    if n == 0:
        return torch.zeros_like(w), torch.zeros((v,), dtype=torch.float32,
                                                device=h.device)
    wp = _packed(w, w_layout, wp)
    dw = torch.empty_like(w)
    db = torch.empty((v,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        _launch(_lib().xent_dwdb, _ptr(h), _ptr(wp), _ptr(b), _ptr(lse), _ptr(g),
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
        # On the card an f32 h is rounded once, here, and the backward's two
        # kernels read the same bf16 copy; dh is returned in h's dtype.
        ctx.h_dtype = h.dtype
        if h.device.type != "cpu":
            h = kernel_h(h)
        lse = xent_fwd(h, w, b, w_layout)
        ctx.save_for_backward(h, w, b, lse)
        ctx.w_layout = w_layout
        return lse

    @staticmethod
    def backward(ctx, g):
        h, w, b, lse = ctx.saved_tensors
        g = g.float().contiguous()
        # One pack a backward, read by both kernels (the plain versions on the
        # CPU round w per chunk themselves).
        wp = None
        if h.shape[0] and (h.device.type != "cpu" or costs.probing()):
            wp = xent_pack_w(w, ctx.w_layout)
        dh = xent_dh(h, w, b, lse, g, ctx.w_layout, wp=wp)
        dw, db = xent_dwdb(h, w, b, lse, g, ctx.w_layout, wp=wp)
        return dh.to(ctx.h_dtype), dw, (db if b is not None else None), None


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
    # Indexing, not index_select: its backward on the card (index_put_ with
    # accumulate) sorts the targets and is deterministic, where
    # index_select's (index_add_, atomics) is not, and a step must repeat
    # itself bit for bit (run_many against run()).
    w_true = (w if _w_vd(w_layout) else w.T)[targets]       # [N, D]
    true_logit = (h.float() * w_true.to(h.dtype).float()).sum(dim=-1)
    if b is not None:
        true_logit = true_logit + b[targets]
    return lse - true_logit
