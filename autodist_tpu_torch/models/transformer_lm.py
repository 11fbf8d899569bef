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
"flash" (:mod:`autodist_tpu_torch.ops.flash_attention`), "blockwise"
(:mod:`autodist_tpu_torch.ops.blockwise_attention`), "ring"
(:mod:`autodist_tpu_torch.parallel.ring_attention`) or "ulysses"
(:mod:`autodist_tpu_torch.parallel.ulysses`), the last two over the
``seq_group`` that ``forward`` is given (the sequence-parallel loss of
:mod:`autodist_tpu_torch.parallel.sequence` passes its group; None is a
group of one), and ``remat``. Decode raises ``NotImplementedError``.
"""

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import (EMBEDDING, HEAD_KERNEL,
                                              fused_lm_head_nll, lm_head_logits)
from autodist_tpu_torch.ops.blockwise_attention import blockwise_attention
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.parallel.ring_attention import ring_attention
from autodist_tpu_torch.parallel.synchronization import global_mean
from autodist_tpu_torch.parallel.ulysses import ulysses_attention

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
    """flax ``DenseGeneral``: a flax-layout ``kernel`` ``[*in, *out]`` whose
    ``n_in`` leading axes contract with the input's last ``n_in`` axes; with
    ``use_bias`` a ``bias`` ``[*out]`` is added in the compute dtype (this
    model's layers have none)."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.in_shape, self.out_shape, self.dtype = in_shape, out_shape, dtype
        self.kernel = _param(*in_shape, *out_shape)
        self.bias = _param(*out_shape) if use_bias else None

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        w = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = (x.to(self.dtype).reshape(*lead, -1) @ w).reshape(*lead, *self.out_shape)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


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

    def forward(self, x, mask, seq_group=None):
        cfg = self.cfg
        q, k, v = self.query(x), self.key(x), self.value(x)
        if cfg.attention_impl == "ring":
            # x is this rank's shard of the sequence: the ring masks by
            # global position, so no local mask is read.
            ctx = ring_attention(q, k, v, causal=True, group=seq_group)
        elif cfg.attention_impl == "ulysses":
            # Head re-sharding: the whole sequence after the exchange.
            ctx = ulysses_attention(q, k, v, causal=True, group=seq_group)
        elif cfg.attention_impl == "flash":
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

    def forward(self, x, mask, seq_group=None):
        x = x + self.attn(self.ln_attn(x), mask, seq_group)
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """The flagship decoder LM. Built on the meta device: apply it to a params
    dict with :func:`apply` (or ``functional_call``)."""

    def __init__(self, config: TransformerLMConfig):
        super().__init__()
        self.config = cfg = config
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        if not cfg.tied_output:
            self.lm_head = Dense((cfg.d_model,), (cfg.vocab_size,), cfg.dtype)

    def forward(self, tokens, pos_offset: int = 0, return_hidden: bool = False,
                decode: bool = False, seq_group=None):
        """``tokens`` int ``[B, L]`` -> logits ``[B, L, V]`` in the compute
        dtype, or the final hidden states ``[B, L, D]`` with
        ``return_hidden`` (the fused-head loss owns the projection).
        ``pos_offset`` is the global position of the first token and
        ``seq_group`` the seq group of ``attention_impl`` "ring" or "ulysses"."""
        if decode:
            raise NotImplementedError("decode (KV-cache) mode is not ported yet")
        cfg = self.config
        length = tokens.shape[1]
        pos = self.pos_embed[pos_offset:pos_offset + length]
        x = self.embed(tokens) + pos[None].to(cfg.dtype)
        # Only dot attention reads the [L, L] mask; the others mask by position.
        mask = (causal_mask(length, cfg.dtype, device=x.device)
                if cfg.attention_impl == "dot" else None)
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            x = (_checkpointed(block, x, mask, seq_group) if cfg.remat
                 else block(x, mask, seq_group))
        x = self.ln_f(x)
        if return_hidden:
            return x
        return lm_head_logits(x, {EMBEDDING: self.embed.embedding} if cfg.tied_output
                              else {HEAD_KERNEL: self.lm_head.kernel},
                              tied=cfg.tied_output)


def _checkpointed(block: Block, x, mask, seq_group=None):
    """``block(x, mask, seq_group)`` with its activations recomputed in the
    backward pass (flax's ``nn.remat``). The block's parameters enter the
    checkpointed function as explicit inputs: :func:`apply` swaps them in
    only while ``functional_call`` runs, and the backward's replay comes
    after it. The replay runs the ring again, on every rank together."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (x, mask, seq_group))

    return torch.utils.checkpoint.checkpoint(run, x, *tensors, use_reentrant=False)


def apply(model: TransformerLM, params: Dict[str, torch.Tensor], tokens, **kwargs):
    """``model(tokens, **kwargs)`` with ``params`` as its parameters."""
    return functional_call(model, params, (tokens,), kwargs)


def init_params(config: TransformerLMConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[TransformerLM, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's initializers
    (:func:`~autodist_tpu_torch.models.layers.init_params`) drawn from a
    ``torch.Generator`` seeded with ``seed`` (the values differ from the JAX
    package's: feed both the same weights through ``from_jax_params``)."""
    model = TransformerLM(config)
    return model, layers.init_params(model, seed, device)


def fused_head_nll(model: TransformerLM, params, inputs, targets,
                   pos_offset: int = 0, seq_group=None) -> torch.Tensor:
    """Per-token NLL ``[B, T]`` through the fused head and loss kernels."""
    h = apply(model, params, inputs, pos_offset=pos_offset, return_hidden=True,
              seq_group=seq_group)
    return fused_lm_head_nll(h, params, targets, tied=model.config.tied_output)


def make_loss_fn(model: TransformerLM) -> Callable:
    """Next-token cross entropy ``loss_fn(params, batch)``; ``batch`` holds
    int ``tokens [B, L+1]`` and optionally a ``mask [B, L+1]`` over them.

    Under data parallelism the loss is the JAX package's global one
    (``autodist_tpu/models/transformer_lm.py:290-297``): the unmasked mean
    over equal rows on every rank is exact under the runner's average, and
    the masked mean ``sum(nll * mask) / max(sum(mask), 1)`` reduces both
    sums over all data ranks' rows of the micro-batch (:func:`global_mean`)."""

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
            return global_mean((nll * mask).sum(), mask.sum())
        return nll.mean()
    return loss_fn


def synthetic_batch(config: TransformerLMConfig, batch_size: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, config.vocab_size,
                                  size=(batch_size, seq_len + 1)).astype(np.int32)}
