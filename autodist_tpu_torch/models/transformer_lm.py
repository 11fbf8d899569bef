"""Decoder-only Transformer language model, the flagship workload
(counterpart of ``autodist_tpu/models/transformer_lm.py``).

The module is the model's structure only, as a flax module is: it is built on
the ``meta`` device and applied to a flat ``{state-dict key: tensor}`` params
dict with :func:`torch.func.functional_call`. Keys are the JAX tree's paths
joined by dots (``block_0.attn.query.kernel``) and every tensor keeps the
JAX layout, so one set of weights feeds both packages
(:mod:`autodist_tpu_torch.params`).

What the port keeps from flax, since each changes the numbers:

- ``DenseGeneral`` kernels are ``[D, H, hd]`` for q/k/v and ``[H, hd, D]``
  for ``out``; dense kernels are ``[in, out]``; no biases.
- Matmuls run in the compute dtype (inputs and f32 params both cast to it).
- LayerNorm: eps 1e-6, statistics in f32 with the variance as
  ``mean(x^2) - mean(x)^2`` clipped at 0, the result cast to the compute dtype.
- GELU is the tanh approximation.
- The causal mask is additive -1e9 in the compute dtype; the score scale
  ``sqrt(hd)`` is rounded to the compute dtype; softmax runs in f32 and is
  cast back.
- The embedding table is cast to the compute dtype before the gather.

Ported: the training (non-decode) path with ``attention_impl`` "dot",
"flash" (:mod:`autodist_tpu_torch.ops.flash_attention`) or "blockwise"
(:mod:`autodist_tpu_torch.ops.blockwise_attention`), and ``remat``. "ring",
"ulysses" and decode raise ``NotImplementedError``.
"""

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from autodist_tpu_torch.models.common import (EMBEDDING, HEAD_KERNEL,
                                              fused_lm_head_nll, lm_head_logits)
from autodist_tpu_torch.ops.blockwise_attention import blockwise_attention
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6
_ATTENTION_IMPLS = ("dot", "flash", "blockwise", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 1024
    dropout: float = 0.0          # unused, as in the JAX model
    dtype: torch.dtype = torch.bfloat16   # activation/compute dtype (params f32)
    remat: bool = False
    attention_impl: str = "dot"
    fused_head: bool = False      # fused head + loss kernels: no logits in memory
    tied_output: bool = True      # head shares the embedding table

    def __post_init__(self):
        if self.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention_impl {self.attention_impl!r}; "
                             f"valid: {', '.join(map(repr, _ATTENTION_IMPLS))}")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")


def causal_mask(length: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Additive ``[L, L]`` mask: 0 on and below the diagonal, -1e9 above."""
    keep = torch.ones((length, length), dtype=torch.bool, device=device).tril()
    return torch.where(keep, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), -1e9, dtype=dtype, device=device))


def dot_product_attention(q, k, v, mask, dtype):
    """Plain softmax attention over ``[B, L, H, hd]`` q/k/v; ``mask`` is
    additive and broadcastable to ``[B, H, Q, K]``."""
    scale = float(torch.tensor(math.sqrt(q.shape[-1])).to(dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device="meta"))


class Dense(nn.Module):
    """Bias-free dense layer with a flax-layout ``kernel`` ``[*in, *out]``;
    ``n_in`` leading kernel axes contract with the input's last ``n_in`` axes."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype: torch.dtype):
        super().__init__()
        self.in_shape, self.out_shape, self.dtype = in_shape, out_shape, dtype
        self.kernel = _param(*in_shape, *out_shape)

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        w = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = x.to(self.dtype).reshape(*lead, -1) @ w
        return y.reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics (see the module docstring)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias
        return y.to(self.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param(vocab, dim)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding.to(self.dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerLMConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.d_model // cfg.n_heads
        for name in ("query", "key", "value"):
            self.add_module(name, Dense((cfg.d_model,), (cfg.n_heads, hd), cfg.dtype))
        self.out = Dense((cfg.n_heads, hd), (cfg.d_model,), cfg.dtype)

    def forward(self, x, mask):
        cfg = self.cfg
        q, k, v = self.query(x), self.key(x), self.value(x)
        if cfg.attention_impl == "flash":
            ctx = flash_attention(q, k, v, causal=True)
        elif cfg.attention_impl == "blockwise":
            # The O(L)-memory path without kernels (the JAX package's choice
            # where its flash kernel cannot compile).
            ctx = blockwise_attention(q, k, v, causal=True)
        else:
            ctx = dot_product_attention(q, k, v, mask, cfg.dtype)
        return self.out(ctx)


class Block(nn.Module):
    def __init__(self, cfg: TransformerLMConfig):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype)
        self.mlp_in = Dense((cfg.d_model,), (cfg.d_ff,), cfg.dtype)
        self.mlp_out = Dense((cfg.d_ff,), (cfg.d_model,), cfg.dtype)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_attn(x), mask)
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """The flagship decoder LM. Built on the meta device: apply it to a params
    dict with :func:`apply` (or ``functional_call``)."""

    def __init__(self, config: TransformerLMConfig):
        super().__init__()
        if config.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={config.attention_impl!r} is not ported yet "
                f"(ROADMAP.md, port queue: sequence parallelism); use 'dot', "
                f"'flash' or 'blockwise'")
        self.config = cfg = config
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        if not cfg.tied_output:
            self.lm_head = Dense((cfg.d_model,), (cfg.vocab_size,), cfg.dtype)

    def forward(self, tokens, pos_offset: int = 0, return_hidden: bool = False,
                decode: bool = False):
        """``tokens`` int ``[B, L]`` -> logits ``[B, L, V]`` in the compute
        dtype, or the final hidden states ``[B, L, D]`` with
        ``return_hidden`` (the fused-head loss owns the projection)."""
        if decode:
            raise NotImplementedError("decode (KV-cache) mode is not ported yet")
        cfg = self.config
        length = tokens.shape[1]
        pos = self.pos_embed[pos_offset:pos_offset + length]
        x = self.embed(tokens) + pos[None].to(cfg.dtype)
        # Only dot attention reads the [L, L] mask; flash and blockwise mask
        # by position.
        mask = (causal_mask(length, cfg.dtype, device=x.device)
                if cfg.attention_impl == "dot" else None)
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            x = _checkpointed(block, x, mask) if cfg.remat else block(x, mask)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return lm_head_logits(x, {EMBEDDING: self.embed.embedding} if cfg.tied_output
                              else {HEAD_KERNEL: self.lm_head.kernel},
                              tied=cfg.tied_output)

    def gather_only_params(self) -> List[str]:
        """JAX-style names of the parameters the loss reads only by gather or
        slice, whose gradients are row-sparse: the declared counterpart of
        ``autodist_tpu.model_spec.detect_sparse_params``."""
        names = ["pos_embed"]
        if not self.config.tied_output:
            names.insert(0, "embed/embedding")
        return names


def _checkpointed(block: Block, x, mask):
    """``block(x, mask)`` with its activations recomputed in the backward
    pass (flax's ``nn.remat``). The block's parameters enter the checkpointed
    function as explicit inputs: :func:`apply` swaps them in only while
    ``functional_call`` runs, and the backward's replay comes after it."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (x, mask))

    return torch.utils.checkpoint.checkpoint(run, x, *tensors, use_reentrant=False)


def apply(model: TransformerLM, params: Dict[str, torch.Tensor], tokens, **kwargs):
    """``model(tokens, **kwargs)`` with ``params`` as its parameters."""
    return functional_call(model, params, (tokens,), kwargs)


def _fan_in_normal(shape, fan_in: int, generator, truncated: bool) -> torch.Tensor:
    """flax's variance-scaling(1, fan_in) initializers: a normal, or a normal
    truncated at two standard deviations and rescaled to unit variance."""
    out = torch.empty(shape, dtype=torch.float32)
    std = 1.0 / math.sqrt(fan_in)
    if truncated:
        std /= 0.87962566103423978
        return nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)
    return nn.init.normal_(out, std=std, generator=generator)


def init_params(config: TransformerLMConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[TransformerLM, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's initializers drawn from a
    ``torch.Generator`` seeded with ``seed`` (the values differ from the JAX
    package's: feed both the same weights through ``from_jax_params``)."""
    device = resolve_device(device)
    model = TransformerLM(config)
    g = torch.Generator().manual_seed(seed)
    params = {}
    for key, p in model.named_parameters():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "scale":
            value = torch.ones(p.shape)
        elif leaf == "bias":
            value = torch.zeros(p.shape)
        elif key == "pos_embed":
            value = nn.init.normal_(torch.empty(p.shape), std=0.02, generator=g)
        elif key == EMBEDDING:
            value = _fan_in_normal(p.shape, p.shape[1], g, truncated=False)
        else:
            module = model.get_submodule(key.rsplit(".", 1)[0])
            value = _fan_in_normal(p.shape, math.prod(module.in_shape), g,
                                   truncated=True)
        params[key] = value.to(device)
    return model, params


def fused_head_nll(model: TransformerLM, params, inputs, targets,
                   pos_offset: int = 0) -> torch.Tensor:
    """Per-token NLL ``[B, T]`` through the fused head and loss kernels."""
    h = apply(model, params, inputs, pos_offset=pos_offset, return_hidden=True)
    return fused_lm_head_nll(h, params, targets, tied=model.config.tied_output)


def make_loss_fn(model: TransformerLM) -> Callable:
    """Next-token cross entropy ``loss_fn(params, batch)``; ``batch`` holds
    int ``tokens [B, L+1]`` and optionally a ``mask [B, L+1]`` over them.
    ``loss_fn.sparse_names`` declares the gather-only parameters."""

    def logits_nll(params, inputs, targets):
        logits = apply(model, params, inputs)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -logprobs.gather(-1, targets[..., None])[..., 0]

    def per_token_nll(params, inputs, targets):
        if model.config.fused_head:
            return fused_head_nll(model, params, inputs, targets)
        return logits_nll(params, inputs, targets)

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        nll = per_token_nll(params, inputs, targets)
        if "mask" in batch:
            mask = batch["mask"][:, 1:].to(nll.dtype)
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()

    loss_fn.sparse_names = model.gather_only_params()
    return loss_fn


def synthetic_batch(config: TransformerLMConfig, batch_size: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, config.vocab_size,
                                  size=(batch_size, seq_len + 1)).astype(np.int32)}
