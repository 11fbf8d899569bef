"""The LSTM recurrence of :mod:`autodist_tpu_torch.models.lstm_lm`: flax's
``OptimizedLSTMCell`` scanned over time, with its backward written out.

No TPU kernel: the JAX package runs the cell under ``lax.scan`` and XLA
fuses each step. Here each step is one cuBLAS product and one hand-written
kernel for everything between products (``csrc/lstm_cell.cu``), forward
(:func:`lstm_cell_fwd`) and backward (:func:`lstm_cell_bwd`); the backward
then takes the weight and bias gradients as one product and one sum over
all steps, where autograd would make them a step at a time. The arithmetic
and its roundings are the module docstring of ``csrc/lstm_cell.cu``'s. The
recurrence is one dispatcher op (``autodist_tpu_torch::lstm_recurrence``)
with a fake implementation, so a fake-tensor trace of the loss records it
once, as the JAX walk sees one ``scan``.

Each kernel has a wrapper that counts its launches in ``launches``. Given
CPU tensors it computes the kernel's plain version
(:func:`cell_fwd_plain`, :func:`cell_bwd_plain`); given CUDA tensors it
launches the kernel or raises, with no fallback.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from autodist_tpu_torch.ops import _build

DTYPES = (torch.bfloat16, torch.float32)   # the compute dtypes the kernels take


def _rd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32."""
    return x.to(dtype).float()


def cell_fwd_plain(yh: Optional[torch.Tensor], bh, xg, c_prev: Optional[torch.Tensor]):
    """Plain version of the forward kernel: ``(c, h, h in the compute
    dtype, gates (i, f, g, o) in it)`` from the hidden-side product ``yh``
    ``[B, 4H]`` (None: a zero carry), the bias, the input side ``xg`` and
    the f32 carry ``c_prev`` (None: zero)."""
    dtype = xg.dtype
    y = bh.float() + (yh.float() if yh is not None else 0.0)
    y = _rd(_rd(y, dtype) + xg.float(), dtype)
    i, f, g, o = y.chunk(4, dim=-1)
    i, f, o = (_rd(torch.sigmoid(v), dtype) for v in (i, f, o))
    g = _rd(torch.tanh(g), dtype)
    c = _rd(i * g, dtype)
    if c_prev is not None:
        c = f * c_prev + c
    h = o * torch.tanh(c)
    return c, h, h.to(dtype), torch.cat([i, f, g, o], dim=-1).to(dtype)


def cell_bwd_plain(dh_out, dh_rec: Optional[torch.Tensor], dc, act, c,
                   c_prev: Optional[torch.Tensor]):
    """Plain version of the backward kernel: ``(dy in the compute dtype,
    the carry's gradient into the step before)`` from the output's gradient
    ``dh_out``, the next step's product ``dh_rec`` (None at the last step),
    the carry's gradient ``dc``, the saved gates and the carries."""
    i, f, g, o = act.float().chunk(4, dim=-1)
    dh = dh_out + (dh_rec.float() if dh_rec is not None else 0.0)
    tc = torch.tanh(c)
    cp = c_prev if c_prev is not None else torch.zeros_like(c)
    dcn = dc + dh * o * (1 - tc * tc)
    dy = torch.cat([dcn * g * i * (1 - i), dcn * cp * f * (1 - f), dcn * i * (1 - g * g),
                    dh * tc * o * (1 - o)], dim=-1)
    return dy.to(act.dtype), dcn * f


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_cell")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_cell_fwd.argtypes = [p, p, p, i, p, i, p, p, i, p, p, i, i, i, i, p]
    lib.lstm_cell_bwd.argtypes = [p, i, p, p, p, i, p, p, i, p, i, i, i, i, p]
    for fn in (lib.lstm_cell_fwd, lib.lstm_cell_bwd):
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> int:
    """The row stride of a kernel operand: ``shape``, ``dtype``, unit stride
    along the row, on the first operand's card (checked by the caller)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.stride(-1) != 1:
        raise ValueError(f"lstm cell kernel: {name} must be {dtype} {tuple(shape)} with "
                         f"unit stride along its rows, got {t.dtype} {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")


def _launch_fwd(*args) -> None:
    """The forward kernel on checked addresses (``csrc/lstm_cell.cu``'s C
    signature); every launch of it goes through here and is counted."""
    _launch(_lib().lstm_cell_fwd, *args)
    lstm_cell_fwd.launches += 1


def _launch_bwd(*args) -> None:
    """The backward kernel, as :func:`_launch_fwd`."""
    _launch(_lib().lstm_cell_bwd, *args)
    lstm_cell_bwd.launches += 1


def _check_device(*tensors):
    dev = tensors[0].device
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("lstm cell kernel inputs must be on one device")


def lstm_cell_fwd(yh, bh, xg, c_prev, c_out, h_out, act_out) -> torch.Tensor:
    """One forward step: writes the new carry into ``c_out`` and ``h_out``
    (f32 ``[B, H]`` views, rows may be strided) and the gates into
    ``act_out`` (``[B, 4H]`` in the compute dtype, ``xg``'s); returns h in
    the compute dtype, the next step's product operand. CUDA: the forward
    kernel; CPU: :func:`cell_fwd_plain`."""
    if xg.device.type == "cpu":
        c, h, h_t, act = cell_fwd_plain(yh, bh, xg, c_prev)
        c_out.copy_(c)
        h_out.copy_(h)
        act_out.copy_(act)
        return h_t
    dtype = xg.dtype
    if dtype not in DTYPES:
        raise TypeError(f"the lstm cell kernels take {DTYPES}, got {dtype}")
    batch, g4 = xg.shape
    hidden = g4 // 4
    _check_device(xg, yh, bh, c_prev, c_out, h_out, act_out)
    ld_xg = _rows(xg, dtype, (batch, g4), "xg")
    if yh is not None and _rows(yh, dtype, (batch, g4), "yh") != g4:
        raise ValueError("lstm cell kernel: yh must be contiguous")
    if not (bh.dtype == dtype and tuple(bh.shape) == (g4,) and bh.is_contiguous()):
        raise ValueError(f"lstm cell kernel: bh must be contiguous {dtype} [{g4}]")
    ld_c = _rows(c_out, torch.float32, (batch, hidden), "c")
    if c_prev is not None and _rows(c_prev, torch.float32, (batch, hidden), "c_prev") != ld_c:
        raise ValueError("lstm cell kernel: c_prev and c must share their row stride")
    ld_h = _rows(h_out, torch.float32, (batch, hidden), "h")
    ld_act = _rows(act_out, dtype, (batch, g4), "act")
    h_t = torch.empty((batch, hidden), dtype=dtype, device=xg.device)
    with torch.cuda.device(xg.device):
        _launch_fwd(_ptr(yh), _ptr(bh), _ptr(xg), ld_xg, _ptr(c_prev), ld_c, _ptr(c_out),
                    _ptr(h_out), ld_h, _ptr(h_t), _ptr(act_out), ld_act, batch, hidden,
                    int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return h_t


def lstm_cell_bwd(dh_out, dh_rec, dc, act, c, c_prev, dy_out) -> None:
    """One backward step: writes ``dy`` (the gates' pre-activation
    gradient, ``[B, 4H]`` in the compute dtype) into ``dy_out`` and the
    carry's gradient into the step before into ``dc`` (f32 ``[B, H]``, in
    place). CUDA: the backward kernel; CPU: :func:`cell_bwd_plain`."""
    if act.device.type == "cpu":
        dy, dc_prev = cell_bwd_plain(dh_out, dh_rec, dc, act, c, c_prev)
        dy_out.copy_(dy)
        dc.copy_(dc_prev)
        return
    dtype = act.dtype
    if dtype not in DTYPES:
        raise TypeError(f"the lstm cell kernels take {DTYPES}, got {dtype}")
    batch, g4 = act.shape
    hidden = g4 // 4
    _check_device(act, dh_out, dh_rec, dc, c, c_prev, dy_out)
    ld_dh = _rows(dh_out, torch.float32, (batch, hidden), "dh_out")
    if dh_rec is not None and _rows(dh_rec, dtype, (batch, hidden), "dh_rec") != hidden:
        raise ValueError("lstm cell kernel: dh_rec must be contiguous")
    if _rows(dc, torch.float32, (batch, hidden), "dc") != hidden:
        raise ValueError("lstm cell kernel: dc must be contiguous")
    ld_act = _rows(act, dtype, (batch, g4), "act")
    ld_c = _rows(c, torch.float32, (batch, hidden), "c")
    if c_prev is not None and _rows(c_prev, torch.float32, (batch, hidden), "c_prev") != ld_c:
        raise ValueError("lstm cell kernel: c_prev and c must share their row stride")
    ld_dy = _rows(dy_out, dtype, (batch, g4), "dy")
    with torch.cuda.device(act.device):
        _launch_bwd(_ptr(dh_out), ld_dh, _ptr(dh_rec), _ptr(dc), _ptr(act), ld_act, _ptr(c),
                    _ptr(c_prev), ld_c, _ptr(dy_out), ld_dy, batch, hidden,
                    int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)


lstm_cell_fwd.launches = 0
lstm_cell_bwd.launches = 0
KERNELS = (lstm_cell_fwd, lstm_cell_bwd)


def _check_recurrence(x_gates, wh, bh) -> None:
    """What the recurrence's CUDA path takes: contiguous ``x_gates [B, T,
    4H]``, ``wh [H, 4H]`` and ``bh [4H]`` in one compute dtype of
    :data:`DTYPES`, on one card. Checked once a call; the steps then pass
    pointers straight to the kernels."""
    dtype = x_gates.dtype
    if dtype not in DTYPES:
        raise TypeError(f"the lstm cell kernels take {DTYPES}, got {dtype}")
    batch, steps, g4 = x_gates.shape
    if g4 % 4 or tuple(wh.shape) != (g4 // 4, g4) or tuple(bh.shape) != (g4,):
        raise ValueError(f"lstm recurrence: x_gates {tuple(x_gates.shape)}, wh "
                         f"{tuple(wh.shape)}, bh {tuple(bh.shape)} do not fit")
    for t in (x_gates, wh, bh):
        if t.dtype != dtype or not t.is_contiguous() or t.device != x_gates.device:
            raise ValueError("lstm recurrence: x_gates, wh and bh must be contiguous, in one "
                             "dtype, on one device")


def _forward_cuda(x_gates, wh, bh, hs, cs, acts, h_init=None) -> None:
    """The forward steps on the card: a product and a kernel launch each,
    the operands' addresses computed, not sliced. ``cs`` may be a view whose
    rows are longer than ``steps`` carries; with ``h_init`` (an initial
    carry's h in the compute dtype) the first step takes its product and the
    carry ``c`` in the slot before ``cs[:, 0]``."""
    batch, steps, g4 = x_gates.shape
    hidden = g4 // 4
    dtype = x_gates.dtype
    size = x_gates.element_size()
    yh = torch.empty((batch, g4), dtype=dtype, device=x_gates.device)
    h_t = torch.empty((batch, hidden), dtype=dtype, device=x_gates.device)
    bf16 = int(dtype == torch.bfloat16)
    xg0, c0, h0, a0 = x_gates.data_ptr(), cs.data_ptr(), hs.data_ptr(), acts.data_ptr()
    ld_c = cs.stride(0)
    carried = h_init is not None
    stream = torch.cuda.current_stream().cuda_stream
    for t in range(steps):
        if t or carried:
            torch.mm(h_t if t else h_init, wh, out=yh)
        _launch_fwd(yh.data_ptr() if t or carried else None, bh.data_ptr(),
                    xg0 + t * g4 * size, steps * g4,
                    c0 + (t - 1) * hidden * 4 if t or carried else None, ld_c,
                    c0 + t * hidden * 4, h0 + t * hidden * 4, steps * hidden, h_t.data_ptr(),
                    a0 + t * g4 * size, steps * g4, batch, hidden, bf16, stream)


def _backward_cuda(dhs, wh, cs, acts, dys) -> None:
    """The backward steps on the card, in reverse: a kernel launch and a
    product each."""
    batch, steps, g4 = acts.shape
    hidden = g4 // 4
    dtype = acts.dtype
    size = acts.element_size()
    dc = torch.zeros((batch, hidden), dtype=torch.float32, device=acts.device)
    dh_rec = torch.empty((batch, hidden), dtype=dtype, device=acts.device)
    bf16 = int(dtype == torch.bfloat16)
    dh0, c0, a0 = dhs.data_ptr(), cs.data_ptr(), acts.data_ptr()
    whT = wh.T
    stream = torch.cuda.current_stream().cuda_stream
    for t in reversed(range(steps)):
        _launch_bwd(dh0 + t * hidden * 4, steps * hidden,
                    dh_rec.data_ptr() if t < steps - 1 else None, dc.data_ptr(),
                    a0 + t * g4 * size, steps * g4, c0 + t * hidden * 4,
                    c0 + (t - 1) * hidden * 4 if t else None, steps * hidden,
                    dys.data_ptr() + t * g4 * size, steps * g4, batch, hidden, bf16, stream)
        if t:
            torch.mm(dys[:, t], whT, out=dh_rec)


# One op to the dispatcher, as lax.scan is one primitive to the JAX walk:
# a fake-tensor trace of the loss (the sparse walk, plan_costs) records the
# recurrence once instead of its T steps, from the fake implementation's
# shapes. Its outputs: h and c for every step (f32 [B, T, H]) and the gates
# (the compute dtype, [B, T, 4H]); c and the gates are for the backward.
@torch.library.custom_op("autodist_tpu_torch::lstm_recurrence", mutates_args=())
def _recurrence(x_gates: torch.Tensor, wh: torch.Tensor,
                bh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    batch, steps, g4 = x_gates.shape
    hidden = g4 // 4
    hs = torch.empty((batch, steps, hidden), dtype=torch.float32, device=x_gates.device)
    cs = torch.empty_like(hs)
    acts = torch.empty_like(x_gates)
    if x_gates.device.type != "cpu":
        _check_recurrence(x_gates, wh, bh)
        with torch.cuda.device(x_gates.device):
            _forward_cuda(x_gates, wh, bh, hs, cs, acts)
        return hs, cs, acts
    h_t = None
    for t in range(steps):
        yh = None if t == 0 else h_t @ wh
        h_t = lstm_cell_fwd(yh, bh, x_gates[:, t], cs[:, t - 1] if t else None, cs[:, t],
                            hs[:, t], acts[:, t])
    return hs, cs, acts


@_recurrence.register_fake
def _recurrence_fake(x_gates, wh, bh):
    batch, steps, g4 = x_gates.shape
    hs = x_gates.new_empty((batch, steps, g4 // 4), dtype=torch.float32)
    return hs, torch.empty_like(hs), torch.empty_like(x_gates)


def _recurrence_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1], *output)


def _recurrence_backward(ctx, dhs, _dcs, _dacts):
    """The steps in reverse, one kernel and one product each; then the
    weight and bias gradients over every step at once."""
    wh, hs, cs, acts = ctx.saved_tensors
    batch, steps, hidden = hs.shape
    dhs = dhs.float().contiguous()
    dys = torch.empty_like(acts)
    if hs.device.type != "cpu":
        with torch.cuda.device(hs.device):
            _backward_cuda(dhs, wh, cs, acts, dys)
    else:
        dc = torch.zeros((batch, hidden), dtype=torch.float32, device=hs.device)
        dh_rec = None
        for t in reversed(range(steps)):
            lstm_cell_bwd(dhs[:, t], dh_rec, dc, acts[:, t], cs[:, t],
                          cs[:, t - 1] if t else None, dys[:, t])
            if t:
                dh_rec = dys[:, t] @ wh.T
    h_prev = torch.cat([hs.new_zeros((batch, 1, hidden)), hs[:, :-1]], dim=1).to(wh.dtype)
    dwh = h_prev.reshape(-1, hidden).T @ dys.reshape(-1, 4 * hidden)
    dbh = dys.float().sum(dim=(0, 1)).to(wh.dtype)
    return dys, dwh, dbh


_recurrence.register_autograd(_recurrence_backward, setup_context=_recurrence_setup)


@register_flop_formula(torch.ops.autodist_tpu_torch.lstm_recurrence)
def _recurrence_flops(x_shape, wh_shape, bh_shape, *args, out_shape=None, **kwargs) -> int:
    """FLOPs of the op for ``FlopCounterMode``: its hidden-side products,
    one ``[B, H] x [H, 4H]`` a step after the first (the backward's run as
    ATen products, which the counter sees)."""
    batch, steps, g4 = x_shape
    return 2 * batch * max(steps - 1, 0) * (g4 // 4) * g4


def _carried(x_gates, wh, bh, c0, h0):
    """The forward steps from the carry ``(c0, h0)`` (no autograd): ``(hs,
    cs)``, f32 ``[B, T, H]`` each. Its own op is not needed: decode runs it
    without gradients."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_gates, wh, bh, c0, h0)):
        raise RuntimeError("lstm_recurrence from an initial carry has no backward; "
                           "call it under torch.no_grad()")
    batch, steps, g4 = x_gates.shape
    hidden = g4 // 4
    dtype = x_gates.dtype
    hs = torch.empty((batch, steps, hidden), dtype=torch.float32, device=x_gates.device)
    # One slot before the steps holds c0, so every step's c_prev shares the
    # row stride of its c (what the kernel takes).
    cs_full = torch.empty((batch, steps + 1, hidden), dtype=torch.float32,
                          device=x_gates.device)
    cs_full[:, 0] = c0
    cs = cs_full[:, 1:]
    acts = torch.empty_like(x_gates)
    h_t = h0.to(dtype)
    if x_gates.device.type != "cpu":
        _check_recurrence(x_gates, wh, bh)
        with torch.cuda.device(x_gates.device):
            _forward_cuda(x_gates, wh, bh, hs, cs, acts, h_init=h_t.contiguous())
        return hs, cs
    for t in range(steps):
        h_t = lstm_cell_fwd(h_t @ wh, bh, x_gates[:, t], cs_full[:, t], cs[:, t], hs[:, t],
                            acts[:, t])
    return hs, cs


def lstm_recurrence(x_gates: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
                    initial_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    return_carry: bool = False):
    """flax's ``OptimizedLSTMCell`` over time: the input side ``x_gates [B,
    T, 4H]`` (its product already taken), the hidden-side kernel ``wh [H,
    4H]`` and bias ``bh [4H]``, all in the compute dtype -> ``h`` for every
    step, f32 ``[B, T, H]``. From a zero carry unless ``initial_carry``
    ``(c, h)`` is given (``[B, H]`` each; c is read in f32, h in the compute
    dtype; no backward then); ``return_carry`` also returns the final carry
    ``(c, h)`` in f32, as ``((c, h), hs)`` (flax ``nn.RNN``'s order)."""
    if initial_carry is None:
        hs, cs, _ = _recurrence(x_gates, wh, bh)
    else:
        c0, h0 = initial_carry
        hs, cs = _carried(x_gates, wh, bh, c0.float(), h0)
    if return_carry:
        return (cs[:, -1], hs[:, -1]), hs
    return hs
