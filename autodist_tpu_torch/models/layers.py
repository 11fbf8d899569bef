"""The flax layers the CNN zoo is built from, with flax's parameter layout
and semantics (the counterparts of ``flax.linen`` ``Conv``, ``Dense``,
``GroupNorm``, ``max_pool`` and ``avg_pool``, and of
``autodist_tpu/models/resnet.py``'s ``SyncBatchNorm``).

Modules are built on the ``meta`` device and applied to a flat
``{state-dict key: tensor}`` params dict with ``functional_call``
(:func:`apply`), as :mod:`autodist_tpu_torch.models.transformer_lm` is.
Parameters keep flax's names and layouts, so ``from_jax_params`` carries
weights across as they are: a conv kernel is ``[kh, kw, in, out]``, a dense
kernel ``[in, out]``, a norm's ``scale`` and ``bias`` ``[C]``.

Activations are NCHW tensors in the channels-last memory format: the NHWC
images a batch holds, permuted (a view, no copy). Each conv permutes its
kernel to OIHW at use. What flax does and torch does not by default, each of
which changes the numbers:

- "SAME" padding is XLA's: a total of ``max((out - 1) s + k - in, 0)`` split
  with the extra row and column after the data (the 7x7/2 stem at 224 pads 2
  before and 3 after); an asymmetric split is an explicit ``F.pad``.
- ``max_pool`` pads "SAME" with -inf; ``avg_pool`` counts the padded zeros
  (it divides by the window size).
- ``GroupNorm`` has epsilon 1e-6 and takes its statistics in f32, the
  variance as ``mean(x^2) - mean(x)^2`` clipped at 0; ``SyncBatchNorm``
  has epsilon 1e-5 and the two-pass variance.
- A layer with ``dtype`` casts its input and parameters to it (a bf16 conv
  runs in bf16); without one it computes in the promoted type.
- Flattening for a dense layer is over NHWC.
"""

import contextlib
import contextvars
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from autodist_tpu_torch.parallel.synchronization import DP_AXES, current_group
from autodist_tpu_torch.utils.device import resolve_device

Pair = Union[int, Tuple[int, int]]


def _pair(x: Pair) -> Tuple[int, int]:
    return (x, x) if isinstance(x, int) else tuple(x)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device="meta"))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``(before, after)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x, window, strides, padding) -> Tuple[int, int, int, int]:
    """``(top, bottom, left, right)`` of ``padding`` ("SAME" or "VALID")."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    top, bottom = same_pads(x.shape[2], window[0], strides[0])
    left, right = same_pads(x.shape[3], window[1], strides[1])
    return top, bottom, left, right


def _padded(x, pads, value=0.0):
    """``(tensor, operator padding)``: a symmetric pad is left to the
    operator as ``(h, w)``; an asymmetric one is applied with ``F.pad``."""
    top, bottom, left, right = pads
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


class Conv(nn.Module):
    """``flax.linen.Conv`` over NCHW (channels-last) activations."""

    def __init__(self, in_features: int, features: int, kernel_size: Pair,
                 strides: Pair = 1, padding: str = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size, self.strides = _pair(kernel_size), _pair(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = _param(*self.kernel_size, in_features, features)
        if use_bias:
            self.bias = _param(features)
        else:
            self.bias = None

    def forward(self, x):
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        w = self.kernel.permute(3, 2, 0, 1).to(dtype, memory_format=torch.channels_last)
        x, pad = _padded(x.to(dtype),
                         _spatial_pads(x, self.kernel_size, self.strides, self.padding))
        y = F.conv2d(x, w, stride=self.strides, padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(dtype).view(1, -1, 1, 1)
        return y


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias``, kernel ``[in, out]``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(in_features, features)
        self.bias = _param(features) if use_bias else None

    def forward(self, x):
        dtype = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` (see the module docstring)."""

    def __init__(self, channels: int, num_groups: int, dtype: Optional[torch.dtype] = None,
                 epsilon: float = 1e-6):
        super().__init__()
        if num_groups <= 0 or channels % num_groups:
            raise ValueError(f"Number of groups ({num_groups}) does not divide the number "
                             f"of channels ({channels}).")
        self.groups, self.dtype, self.epsilon = num_groups, dtype, epsilon
        self.scale = _param(channels)
        self.bias = _param(channels)

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.float()
        # Per-channel means, then per group: every channel of a group
        # covers the same number of elements.
        mean = xf.mean(dim=(2, 3)).view(b, self.groups, -1).mean(-1)
        mean2 = (xf * xf).mean(dim=(2, 3)).view(b, self.groups, -1).mean(-1)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        per_c = c // self.groups
        mean = mean.repeat_interleave(per_c, dim=1).view(b, c, 1, 1)
        var = var.repeat_interleave(per_c, dim=1).view(b, c, 1, 1)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.view(1, c, 1, 1)
        y = (xf - mean) * mul + self.bias.view(1, c, 1, 1)
        return y.to(self.dtype or y.dtype)


# (mean, var) of each SyncBatchNorm site, collected while a calibration pass
# runs (``calibrate_bn_ema``); None otherwise.
_BN_STATS: contextvars.ContextVar = contextvars.ContextVar("bn_stats", default=None)


@contextlib.contextmanager
def collect_bn_stats():
    """Within it, every batch-statistics ``SyncBatchNorm`` records its
    ``[2, C]`` (mean, var) under its site's name in the yielded dict."""
    stats: Dict[str, torch.Tensor] = {}
    token = _BN_STATS.set(stats)
    try:
        yield stats
    finally:
        _BN_STATS.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose gradient is the sum of the gradients
    (every rank's loss reads every rank's input through it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class SyncBatchNorm(nn.Module):
    """``autodist_tpu/models/resnet.py``'s ``SyncBatchNorm``: train-mode
    BatchNorm as a pure function of the batch, with f32 statistics over the
    batch and spatial dims. Inside a runner's step under data parallelism
    the sums cover the global batch (an all-reduce over the data ranks that
    autograd differentiates), as GSPMD's are in the JAX package. With
    ``use_ema`` it normalizes with the stored statistics ``stats`` ``[2, C]``
    (a buffer, given with the params: the ``bn_ema`` collection)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None,
                 epsilon: float = 1e-5, use_ema: bool = False):
        super().__init__()
        self.dtype, self.epsilon, self.use_ema = dtype, epsilon, use_ema
        self.site = ""
        self.scale = _param(channels)
        self.bias = _param(channels)
        if use_ema:
            self.register_buffer("stats", torch.empty((2, channels), device="meta"))

    def forward(self, x):
        c = x.shape[1]
        xf = x.float()
        if self.use_ema:
            mean, var = self.stats[0], self.stats[1]
        else:
            group = current_group(DP_AXES)
            count = torch.tensor(float(xf.numel() // c), device=x.device)
            total = xf.sum(dim=(0, 2, 3))
            if group is not None:
                count = _AllReduceSum.apply(count, group)
                total = _AllReduceSum.apply(total, group)
            mean = total / count
            sq = ((xf - mean.view(1, c, 1, 1)) ** 2).sum(dim=(0, 2, 3))
            if group is not None:
                sq = _AllReduceSum.apply(sq, group)
            var = sq / count
            collected = _BN_STATS.get()
            if collected is not None:
                collected[self.site] = torch.stack([mean, var]).detach()
        y = (xf - mean.view(1, c, 1, 1)) * torch.rsqrt(var.view(1, c, 1, 1) + self.epsilon)
        y = y * self.scale.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)
        return y.to(self.dtype or y.dtype)


def max_pool(x, window: Pair, strides: Optional[Pair] = None, padding: str = "VALID"):
    """``flax.linen.max_pool``: "SAME" pads with -inf."""
    window = _pair(window)
    strides = _pair(strides) if strides is not None else (1, 1)
    x, pad = _padded(x, _spatial_pads(x, window, strides, padding), value=float("-inf"))
    return F.max_pool2d(x, window, strides, padding=pad)


def avg_pool(x, window: Pair, strides: Optional[Pair] = None, padding: str = "VALID"):
    """``flax.linen.avg_pool`` with ``count_include_pad=True``: the sum over
    the window, padded zeros included, over the window's size."""
    window = _pair(window)
    strides = _pair(strides) if strides is not None else (1, 1)
    x, pad = _padded(x, _spatial_pads(x, window, strides, padding))
    return F.avg_pool2d(x, window, strides, padding=pad, count_include_pad=True)


def nchw(images) -> torch.Tensor:
    """NHWC images ``[B, H, W, C]`` as the NCHW channels-last view the
    layers take."""
    return torch.as_tensor(images).permute(0, 3, 1, 2)


def flatten_nhwc(x) -> torch.Tensor:
    """``x.reshape((B, -1))`` of the NHWC array flax flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def name_sites(model: nn.Module) -> nn.Module:
    """Give every SyncBatchNorm its module path, the key of its statistics."""
    for name, module in model.named_modules():
        if isinstance(module, SyncBatchNorm):
            module.site = name
    return model


def apply(model: nn.Module, params: Dict[str, torch.Tensor], *args, **kwargs):
    """``model(*args)`` with ``params`` (and any buffers, such as the
    ``bn_ema`` statistics, in the same flat dict) as its tensors."""
    return functional_call(model, params, args, kwargs)


def _lecun_normal(shape: Sequence[int], fan_in: int, generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    rescaled to variance ``1 / fan_in``."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    out = torch.empty(tuple(shape), dtype=torch.float32)
    return nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_params(model: nn.Module, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, torch.Tensor]:
    """flax's default initializers for every parameter of ``model``, drawn
    in its parameter order from a ``torch.Generator`` seeded with ``seed``:
    a ``kernel`` ``lecun_normal`` over its input axes (a ``DenseGeneral``'s
    ``in_shape``, else every dim but the last), an ``embedding`` table
    normal with variance ``1 / dim`` (``nn.Embed``'s), ``pos_embed``
    normal(0.02), a ``scale`` 1 and a bias 0. The values differ from the JAX
    package's: feed both the same weights through ``from_jax_params``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    params = {}
    for key, p in model.named_parameters():
        owner, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            in_shape = getattr(model.get_submodule(owner), "in_shape", p.shape[:-1])
            value = _lecun_normal(p.shape, math.prod(in_shape), g)
        elif leaf == "embedding":
            value = nn.init.normal_(torch.empty(p.shape), std=1.0 / math.sqrt(p.shape[-1]),
                                    generator=g)
        elif leaf == "pos_embed":
            value = nn.init.normal_(torch.empty(p.shape), std=0.02, generator=g)
        elif leaf == "scale":
            value = torch.ones(p.shape)
        else:
            value = torch.zeros(p.shape)
        params[key] = value.to(device)
    return params
