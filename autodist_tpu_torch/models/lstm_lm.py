"""LSTM language model with sampled softmax, lm1b's model family (counterpart
of ``autodist_tpu/models/lstm_lm.py``).

As :mod:`autodist_tpu_torch.models.transformer_lm`, the module is the
structure only: built on the ``meta`` device and applied to a flat
``{state-dict key: tensor}`` params dict with ``functional_call``. Keys are
the JAX tree's paths joined by dots, which are flax's names, not the ones
the JAX code suggests: ``nn.RNN``'s ``name=f"lstm_{i}"`` does not reach the
tree, whose cells are ``lm.OptimizedLSTMCell_{i}`` with input kernels
``ii``, ``if``, ``ig``, ``io`` (``[in, H]``, no bias) and hidden kernels and
biases ``hi``, ``hf``, ``hg``, ``ho`` (``[H, H]``, ``[H]``); the table is
``lm.embed.embedding``, the head ``softmax_w [V, H]`` and ``softmax_b [V]``.
So ``from_jax_params`` carries a JAX tree across as it is.

The recurrence is flax's ``OptimizedLSTMCell`` under ``nn.RNN`` (a
``lax.scan``; no TPU kernel), run as a loop over time steps in
:func:`~autodist_tpu_torch.ops.lstm_cell.lstm_recurrence` (a step is one
product and one hand-written kernel each way). What the port keeps, since
each changes the numbers:

- Gate order (i, f, g, o); sigmoid gates, tanh cell input and output.
- The input-side product ``x . [ii|if|ig|io]`` has no bias and does not
  depend on the carry: one ``[B T, in] x [in, 4H]`` product a layer before
  the loop. Only the hidden-side product runs per step.
- The compute dtype: both products' operands are cast to it and their
  results are in it (bf16 products accumulate in f32), the hidden-side
  bias is added in it and the gates are taken in it, as flax's
  ``promote_dtype`` does. The carry ``(c, h)`` starts at the parameter
  dtype, f32, and stays f32 (``f * c`` and ``o * tanh(c)`` promote), so
  the model hands the head f32 ``h`` even with a bf16 compute dtype.
- The embedding rows are gathered in f32 and cast to the compute dtype
  (flax casts the table and gathers: the same values).

Decode (``autodist_tpu/models/lstm_lm.py:53-78``): flax's ``cache``
collection is explicit state, :func:`init_cache`'s dict of each layer's
carry ``lm.carry_{i}`` = ``(c, h)``, ``[B, H]`` each, which ``apply(...,
decode=True, cache=cache)`` updates in place. flax creates that carry in the
compute dtype, not f32 as the training path's, so at bf16 its decode
rounds ``c`` and ``h`` to bf16 every step; the port runs the recurrence one
step at a time from the carry and rounds both to the compute dtype between
steps (at f32 it runs all steps in one call: no rounding to do). Within a
step the kernel keeps ``f * c_prev + i * g`` and ``o * tanh(c)`` in f32
where flax rounds each product to bf16 first: the bf16 gap is a last-bit
one, held by the tests. :func:`generate` is the prefill-then-step loop with
the full-softmax head.
"""

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import make_keys, row_seeds, sample_logits
from autodist_tpu_torch.ops.fused_xent import fused_softmax_xent
from autodist_tpu_torch.ops.lstm_cell import lstm_recurrence
from autodist_tpu_torch.utils.device import resolve_device

GATES = "ifgo"


@dataclasses.dataclass(frozen=True)
class LSTMLMConfig:
    vocab_size: int = 32000       # lm1b's real vocabulary: 793,471
    emb_dim: int = 512
    hidden_dim: int = 1024
    n_layers: int = 2
    num_sampled: int = 1024       # sampled-softmax negatives per batch
    # Subtract log q(id) of the log-uniform sampler from the sampled logits
    # (TF's sampled_softmax_loss default, which lm1b relies on).
    subtract_log_q: bool = True
    dtype: torch.dtype = torch.bfloat16   # compute dtype (params and carry f32)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device="meta"))


class _DenseParams(nn.Module):
    """flax ``DenseParams``: a ``kernel [in, out]`` and, optionally, a
    ``bias [out]``; the cell applies them."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool):
        super().__init__()
        self.kernel = _param(in_dim, out_dim)
        self.bias = _param(out_dim) if use_bias else None


class OptimizedLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` scanned over time: ``[B, T, in]`` ->
    ``[B, T, H]`` f32, from a zero carry."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        for gate in GATES:
            self.add_module(f"i{gate}", _DenseParams(in_dim, hidden, use_bias=False))
            self.add_module(f"h{gate}", _DenseParams(hidden, hidden, use_bias=True))

    def _cat(self, side: str, leaf: str) -> torch.Tensor:
        return torch.cat([getattr(getattr(self, f"{side}{gate}"), leaf) for gate in GATES],
                         dim=-1).to(self.dtype)

    def forward(self, x: torch.Tensor, carry=None) -> torch.Tensor:
        """With ``carry`` (the decode cache's ``(c, h)`` in the compute
        dtype) the recurrence starts from it, rounds it to the compute dtype
        after every step as flax's decode carry is, writes the final one back
        in place and returns ``h`` in the compute dtype."""
        x_gates = x.to(self.dtype) @ self._cat("i", "kernel")          # [B, T, 4H]
        wh, bh = self._cat("h", "kernel"), self._cat("h", "bias")
        if carry is None:
            return lstm_recurrence(x_gates, wh, bh)
        c, h = carry
        steps = x_gates.shape[1]
        chunk = steps if self.dtype == torch.float32 else 1
        outs = []
        for t in range(0, steps, chunk):
            (c_t, _), hs = lstm_recurrence(x_gates[:, t:t + chunk].contiguous(), wh, bh,
                                           initial_carry=(c, h), return_carry=True)
            c, h = c_t.to(self.dtype), hs[:, -1].to(self.dtype)
            outs.append(hs.to(self.dtype))
        carry[0].copy_(c)
        carry[1].copy_(h)
        return torch.cat(outs, dim=1)


class LSTMLM(nn.Module):
    """Embedding -> stacked LSTM -> hidden states ``[B, T, H]`` (f32)."""

    def __init__(self, config: LSTMLMConfig):
        super().__init__()
        self.config = cfg = config
        self.embed = nn.Module()
        self.embed.embedding = _param(cfg.vocab_size, cfg.emb_dim)
        for i in range(cfg.n_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", OptimizedLSTMCell(
                cfg.emb_dim if i == 0 else cfg.hidden_dim, cfg.hidden_dim, cfg.dtype))

    def forward(self, tokens: torch.Tensor, decode: bool = False, cache=None) -> torch.Tensor:
        """``decode``: run from and update the carries of ``cache`` (its
        ``carry_{i}`` entries, see :func:`init_cache`)."""
        cfg = self.config
        if decode and cache is None:
            raise ValueError("decode=True needs cache=init_cache(config, batch)")
        x = F.embedding(tokens, self.embed.embedding).to(cfg.dtype)
        for i in range(cfg.n_layers):
            cell = getattr(self, f"OptimizedLSTMCell_{i}")
            x = cell(x, cache[f"carry_{i}"]) if decode else cell(x)
        return x


class LSTMLMWithHead(nn.Module):
    """The LM and the softmax parameters in one tree; applied, it returns
    the hidden states (the loss owns the projection)."""

    def __init__(self, config: LSTMLMConfig):
        super().__init__()
        self.config = config
        self.lm = LSTMLM(config)
        self.softmax_w = _param(config.vocab_size, config.hidden_dim)
        self.softmax_b = _param(config.vocab_size)

    def forward(self, tokens: torch.Tensor, decode: bool = False, cache=None) -> torch.Tensor:
        if decode and cache is None:
            raise ValueError("decode=True needs cache=init_cache(config, batch)")
        lm_cache = ({k[len("lm."):]: v for k, v in cache.items() if k.startswith("lm.")}
                    if decode else None)
        return self.lm(tokens, decode=decode, cache=lm_cache)


def apply(model: LSTMLMWithHead, params: Dict[str, torch.Tensor], tokens,
          **kwargs) -> torch.Tensor:
    """``model(tokens, **kwargs)`` with ``params`` as its parameters."""
    return functional_call(model, params, (tokens,), kwargs)


def _log_q(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """log of the log-uniform sampler's probability of ``ids``, less the
    ``log(log(V + 1))`` shared by every class."""
    idf = ids.float()
    return torch.log(torch.log1p(1.0 / (idf + 1.0))) - math.log(math.log(float(vocab_size + 1)))


def make_loss_fn(model: LSTMLMWithHead) -> Callable:
    """Sampled-softmax NLL ``loss_fn(params, batch)``.

    ``batch``: int ``tokens [B, L+1]`` (inputs and targets shifted inside)
    and optionally int ``neg_ids [S]``, negatives sampled on the host and
    shared by the batch. The true class's logit and the negatives' come
    from gathered rows of ``softmax_w`` (row-sparse gradients), in h's dtype
    (f32) with f32 results; with ``subtract_log_q`` each has ``log q``
    subtracted; a negative equal to the target is masked to -1e9; the NLL
    is that of position 0 of ``[true | negatives]``. Without ``neg_ids`` it
    is the full softmax."""

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        h = apply(model, params, inputs)
        w, b = params["softmax_w"], params["softmax_b"]
        if "neg_ids" not in batch:
            logits = (h @ w.T.to(h.dtype)).float() + b
            logprobs = torch.log_softmax(logits, dim=-1)
            return -logprobs.gather(-1, targets[..., None])[..., 0].mean()
        neg_ids = batch["neg_ids"].long()
        # Indexing, not index_select: its backward is deterministic on the
        # card (see ops/fused_xent.py's fused_softmax_xent).
        w_true = w[targets].to(h.dtype)                          # [B, T, H]
        true_logit = (h * w_true).sum(-1).float() + b[targets]
        w_neg = w[neg_ids].to(h.dtype)                           # [S, H]
        neg_logits = (h @ w_neg.T).float() + b[neg_ids]
        if model.config.subtract_log_q:
            vocab = model.config.vocab_size
            true_logit = true_logit - _log_q(targets, vocab)
            neg_logits = neg_logits - _log_q(neg_ids, vocab)
        hits = neg_ids[None, None, :] == targets[..., None]     # accidental hits
        neg_logits = torch.where(hits, torch.full_like(neg_logits, -1e9), neg_logits)
        all_logits = torch.cat([true_logit[..., None], neg_logits], dim=-1)
        return (-true_logit + torch.logsumexp(all_logits, dim=-1)).mean()

    return loss_fn


def make_fused_full_softmax_loss_fn(model: LSTMLMWithHead) -> Callable:
    """The exact full-vocabulary NLL through the fused head
    (:func:`~autodist_tpu_torch.ops.fused_xent.fused_softmax_xent`, table
    ``softmax_w`` in its stored ``"vd"`` layout and f32, with the bias): the
    ``[B T, V]`` logits never exist. On the card the LSTM's f32 ``h`` is
    rounded to bf16 once a call for the kernels. ``batch`` needs only
    ``tokens``."""

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        h = apply(model, params, inputs)
        n = h.shape[0] * h.shape[1]
        nll = fused_softmax_xent(h.reshape(n, h.shape[-1]), params["softmax_w"],
                                 targets.reshape(n), params["softmax_b"], w_layout="vd")
        return nll.mean()

    return loss_fn


def init_cache(config: LSTMLMConfig, batch: int,
               device: Optional[Union[str, torch.device]] = None):
    """Zero decode carries for ``batch`` rows, keyed as flax's ``cache``
    collection of :class:`LSTMLMWithHead`: ``lm.carry_{i}`` = ``(c, h)``,
    ``[batch, H]`` each in the compute dtype, on ``device`` (the card unless
    the CPU is asked for)."""
    device = resolve_device(device)
    return {f"lm.carry_{i}": tuple(torch.zeros((batch, config.hidden_dim), dtype=config.dtype,
                                               device=device) for _ in range(2))
            for i in range(config.n_layers)}


def head_logits(h: torch.Tensor, params) -> torch.Tensor:
    """The full-softmax head on ``[B, H]`` hidden states: f32 ``[B, V]``
    logits, the table cast to h's dtype and the products accumulated in f32
    (the JAX head's ``preferred_element_type``), plus the bias."""
    w = params["softmax_w"].to(h.dtype)
    return h.float() @ w.float().T + params["softmax_b"]


def generate(model: LSTMLMWithHead, params, prompt, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             rng: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation (``autodist_tpu/models/lstm_lm.py:185-240``):
    int ``[B, P]`` prompt -> int32 ``[B, max_new_tokens]``, the full-softmax
    head, on the params' device. One prefill apply threads the prompt
    through the carries, then one decode apply a token; sampling keys as
    :func:`~autodist_tpu_torch.models.transformer_lm.generate`'s."""
    device = params["softmax_w"].device
    prompt = torch.as_tensor(prompt).to(device=device, dtype=torch.long)
    if prompt.shape[1] < 1:
        raise ValueError("prompt must have at least one token")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    batch = prompt.shape[0]
    keys = make_keys(0 if rng is None else rng, max_new_tokens)
    with torch.no_grad():
        cache = init_cache(model.config, batch, device)
        h = apply(model, params, prompt, decode=True, cache=cache)
        tok = sample_logits(head_logits(h[:, -1], params), row_seeds(keys[0], batch, device),
                            temperature, top_k, top_p)
        out = [tok]
        for i in range(1, max_new_tokens):
            h = apply(model, params, tok[:, None].long(), decode=True, cache=cache)
            tok = sample_logits(head_logits(h[:, 0], params), row_seeds(keys[i], batch, device),
                                temperature, top_k, top_p)
            out.append(tok)
    return torch.stack(out, dim=1)


def make_generate_fn(model: LSTMLMWithHead, max_new_tokens: int, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0) -> Callable:
    """``f(params, prompt, rng=None)`` closing over the statics."""
    def f(params, prompt, rng=None):
        return generate(model, params, prompt, max_new_tokens, temperature=temperature,
                        top_k=top_k, top_p=top_p, rng=rng)
    return f


def init_params(config: LSTMLMConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[LSTMLMWithHead, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's initializers, drawn from a
    ``torch.Generator`` seeded with ``seed``: input kernels
    ``lecun_normal``, hidden kernels orthogonal, biases 0, the table
    ``nn.Embed``'s normal, ``softmax_w`` normal(0.02), ``softmax_b`` 0. The
    values differ from the JAX package's: feed both the same weights
    through ``from_jax_params``."""
    model = LSTMLMWithHead(config)
    params = layers.init_params(model, seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for key, value in params.items():
        owner, _, leaf = key.rpartition(".")
        if leaf == "kernel" and owner.rpartition(".")[2].startswith("h"):
            params[key] = nn.init.orthogonal_(torch.empty(value.shape), generator=g)
    params["softmax_w"] = nn.init.normal_(torch.empty(params["softmax_w"].shape), std=0.02,
                                          generator=g)
    device = resolve_device(device)
    return model, {k: v.to(device) for k, v in params.items()}


def synthetic_batch(config: LSTMLMConfig, batch_size: int, seq_len: int, seed: int = 0,
                    sampled: bool = True) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value: tokens, and with
    ``sampled`` log-uniform negatives drawn on the host."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, config.vocab_size,
                                   size=(batch_size, seq_len + 1)).astype(np.int32)}
    if sampled:
        u = rng.uniform(size=(config.num_sampled,))
        ids = (np.exp(u * np.log(config.vocab_size + 1)) - 1).astype(np.int64)
        batch["neg_ids"] = np.clip(ids, 0, config.vocab_size - 1).astype(np.int32)
    return batch
