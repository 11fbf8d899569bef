"""BERT encoder with the masked-LM pretraining loss (counterpart of
``autodist_tpu/models/bert.py``).

Built on the ``meta`` device and applied to a flat ``{state-dict key:
tensor}`` params dict (:func:`apply`), as
:mod:`autodist_tpu_torch.models.transformer_lm` is; keys and layouts are the
flax tree's (``layer_0.query.kernel`` ``[d, H, hd]``, ``layer_0.out.kernel``
``[H, hd, d]``, ``pos_embed`` ``[max_len, d]``), so ``from_jax_params``
carries JAX weights across. What the port keeps from flax, since each
changes the numbers:

- Attention is ``DenseGeneral`` with biases (``[H, hd]`` for q, k and v,
  ``[d]`` for ``out``); the MLP's GELU is the tanh approximation.
- The pad mask is additive, -1e9 in the compute dtype, ``[B, 1, 1, L]``,
  keyed on ``tokens == 0``.
- ``pos_embed`` is f32, sliced to the length and then cast.
- The prediction slots are gathered before the head, which is the tied
  embedding table in the compute dtype; the loss takes its log-softmax in
  f32.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import EMBEDDING, lm_head_logits
from autodist_tpu_torch.models.transformer_lm import (Dense, Embed, LayerNorm, _param,
                                                      dot_product_attention)
from autodist_tpu_torch.parallel.synchronization import global_mean


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dtype: torch.dtype = torch.bfloat16


class EncoderBlock(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = cfg.dtype
        hd = cfg.d_model // cfg.n_heads
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype)
        for name in ("query", "key", "value"):
            self.add_module(name, Dense((cfg.d_model,), (cfg.n_heads, hd), cfg.dtype,
                                        use_bias=True))
        self.out = Dense((cfg.n_heads, hd), (cfg.d_model,), cfg.dtype, use_bias=True)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype)
        self.mlp_in = layers.Dense(cfg.d_model, cfg.d_ff, dtype=cfg.dtype)
        self.mlp_out = layers.Dense(cfg.d_ff, cfg.d_model, dtype=cfg.dtype)

    def forward(self, x, pad_mask):
        h = self.ln_attn(x)
        ctx = dot_product_attention(self.query(h), self.key(h), self.value(h), pad_mask,
                                    self.dtype)
        x = x + self.out(ctx)
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class Bert(nn.Module):
    """The encoder. Built on the meta device: apply it to a params dict with
    :func:`apply`."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = cfg = config
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        self.type_embed = Embed(cfg.type_vocab, cfg.d_model, cfg.dtype)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, tokens, token_types, mlm_positions=None):
        """int ``[B, L]`` tokens and token types -> tied MLM logits in the
        compute dtype: ``[B, P, V]`` at the ``mlm_positions`` ``[B, P]``,
        else ``[B, L, V]``."""
        cfg = self.config
        tokens = tokens.long()
        length = tokens.shape[1]
        # Unsqueezed before the slice, as flax's pos[None, :length] is: the
        # walk then sees no gather of the table (it is dense in both packages).
        pos = self.pos_embed[None, :length, :].to(cfg.dtype)
        x = self.embed(tokens) + self.type_embed(token_types.long()) + pos
        pad_mask = torch.where((tokens == 0)[:, None, None, :],
                               torch.full((), -1e9, dtype=cfg.dtype, device=x.device),
                               torch.zeros((), dtype=cfg.dtype, device=x.device))
        for i in range(cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask)
        x = self.ln_f(x)
        if mlm_positions is not None:
            # The prediction slots before the vocab projection: the head runs
            # on [B, P, d], not [B, L, d].
            idx = mlm_positions.long()[..., None].expand(-1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        return lm_head_logits(x, {EMBEDDING: self.embed.embedding}, tied=True)


def apply(model: Bert, params: Dict[str, torch.Tensor], tokens, token_types,
          mlm_positions=None):
    """``model(tokens, token_types, mlm_positions)`` with ``params``."""
    return layers.apply(model, params, tokens, token_types, mlm_positions=mlm_positions)


def init_params(config: BertConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[Bert, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's default initializers
    (:func:`~autodist_tpu_torch.models.layers.init_params`) drawn from a
    ``torch.Generator`` seeded with ``seed``; the values differ from the JAX
    package's."""
    model = Bert(config)
    return model, layers.init_params(model, seed, device)


def make_mlm_loss_fn(model: Bert) -> Callable:
    """Masked-LM loss ``loss_fn(params, batch)``; ``batch`` holds ``tokens``,
    ``token_types``, ``mlm_positions``, ``mlm_targets`` and ``mlm_weights``
    (a fixed number of prediction slots). The weighted mean NLL
    ``sum(nll * w) / max(sum(w), 1)``; under data parallelism both sums
    cover every data rank's rows (:func:`global_mean`), as the JAX package's
    global batch does."""

    def loss_fn(params, batch):
        logits = apply(model, params, batch["tokens"], batch["token_types"],
                       mlm_positions=batch["mlm_positions"])
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        nll = -logprobs.gather(-1, batch["mlm_targets"].long()[..., None])[..., 0]
        w = batch["mlm_weights"].to(nll.dtype)
        return global_mean((nll * w).sum(), w.sum())

    return loss_fn


def synthetic_batch(config: BertConfig, batch_size: int, seq_len: int = 128,
                    n_predictions: int = 20, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {
        "tokens": rng.randint(1, config.vocab_size, size=(batch_size, seq_len)).astype(np.int32),
        "token_types": np.zeros((batch_size, seq_len), np.int32),
        "mlm_positions": rng.randint(0, seq_len, size=(batch_size, n_predictions)).astype(np.int32),
        "mlm_targets": rng.randint(1, config.vocab_size, size=(batch_size, n_predictions)).astype(np.int32),
        "mlm_weights": np.ones((batch_size, n_predictions), np.float32),
    }
