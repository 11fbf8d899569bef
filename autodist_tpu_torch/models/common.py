"""Helpers shared by the port's models (``autodist_tpu/models/common.py``).

- The LM head (``:62-88``): one definition of which parameter is the head
  table and in which layout: untied, ``lm_head.kernel`` ``[D, V]`` (layout
  ``"dv"``); tied, ``embed.embedding`` ``[V, D]`` (layout ``"vd"``).
- Generation's sampling step ``sample_logits`` (``:29-59``) and the key
  schedule its callers share (:func:`make_keys`).
- The CNN zoo's ``num_groups`` (``:20-27``) and classification loss
  (``:91-99``).

``params`` is the flat ``{state-dict key: tensor}`` dict the models are
applied with.
"""

from typing import Callable, Optional

import numpy as np
import torch

from autodist_tpu_torch.models.layers import apply
from autodist_tpu_torch.ops.fused_xent import fused_softmax_xent

HEAD_KERNEL = "lm_head.kernel"
EMBEDDING = "embed.embedding"


def lm_head_logits(h: torch.Tensor, params, tied: bool = False) -> torch.Tensor:
    """``[..., D]`` hidden -> ``[..., V]`` logits, the table cast to the
    activation dtype as the flax head does."""
    if tied:
        return h @ params[EMBEDDING].to(h.dtype).T
    return h @ params[HEAD_KERNEL].to(h.dtype)


def fused_lm_head_nll(h: torch.Tensor, params, targets: torch.Tensor,
                      tied: bool = False) -> torch.Tensor:
    """Per-token f32 NLL ``[B, T]`` through the fused head and loss: the
    ``[B*T, V]`` logits never exist in memory."""
    h2 = h.reshape(-1, h.shape[-1])
    if tied:
        nll = fused_softmax_xent(h2, params[EMBEDDING], targets.reshape(-1),
                                 w_layout="vd")
    else:
        nll = fused_softmax_xent(h2, params[HEAD_KERNEL], targets.reshape(-1))
    return nll.reshape(targets.shape)


# Counter-based sampling noise: a 32-bit hash of (seed, vocabulary index)
# in int64 arithmetic, every product under 2**63 (multipliers < 2**31).
_MASK32 = 0xFFFFFFFF
_HASH_MUL = (0x7FEB352D, 0x68E31DA5)
# Row b of generate()'s batch samples with step seed + b * _ROW_STRIDE, so
# row 0 uses the step's seed itself, as a served request of one row does.
_ROW_STRIDE = 0x9E3779B9


def make_keys(seed: int, n: int) -> np.ndarray:
    """A request's per-step sampling seeds: ``n`` int64 values in [0, 2**32)
    drawn from ``numpy``'s ``SeedSequence(seed)``. :func:`generate` and the
    serving engines use the same schedule, so a request served alone equals
    ``generate`` with its seed, token for token. (The JAX package's schedule
    is ``jax.random.split(PRNGKey(seed), n)``; torch cannot reproduce
    ``jax.random.categorical``, so sampled tokens have no parity with JAX.)"""
    return np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint32).astype(np.int64)


def row_seeds(step_seed: int, rows: int, device=None) -> torch.Tensor:
    """``[rows]`` int64 seeds of one step of a batch: ``step_seed`` for row 0,
    then a stride of the golden-ratio constant, mod 2**32."""
    b = torch.arange(rows, dtype=torch.int64, device=device)
    return (int(step_seed) + b * _ROW_STRIDE) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    for mul in _HASH_MUL:
        x = x ^ (x >> 16)
        x = (x * mul) & _MASK32
    return x ^ (x >> 15)


def uniform_noise(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """f32 ``[B, n]`` in (0, 1): row b is a function of ``seeds[b]`` and the
    column index only, so a row's draw does not depend on its batch mates."""
    h = _mix32(seeds.to(torch.int64)[:, None] & _MASK32)
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)
    x = _mix32(_mix32(h ^ idx) ^ h)
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The JAX sampler's filter, in f32: ``logits / temperature``, then the
    ``top_k`` best kept, then the nucleus: ranks whose preceding mass is under
    ``top_p`` (the token crossing the threshold kept, so never empty). The
    rest are ``-inf``."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p > 0.0:
        ranked = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(ranked, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                          cum[..., :-1] < top_p], dim=-1)
        cutoff = torch.where(keep, ranked, float("inf")).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_logits(logits: torch.Tensor, key: Optional[torch.Tensor] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """One sampling step over ``[B, V]`` logits -> ``[B]`` int32 tokens.

    ``temperature=0`` is greedy argmax (the first maximum; ``key`` unused).
    Otherwise :func:`filter_logits`, then a categorical draw by the Gumbel-max
    trick, its noise counter-based from ``key``, ``[B]`` int seeds, one a row
    (:func:`uniform_noise`): the port's ``jax.random`` key, never the global
    RNG."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    if key is None:
        raise ValueError("sampling at temperature > 0 needs a key: one int seed a row")
    logits = filter_logits(logits, temperature, top_k, top_p)
    gumbel = -torch.log(-torch.log(uniform_noise(key.to(logits.device), logits.shape[-1])))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def num_groups(channels: int, max_groups: int) -> int:
    """Largest GroupNorm group count <= max_groups that divides the channel
    count (CNN widths like 80/48/76 are not multiples of the usual 32)."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def make_classification_loss_fn(model) -> Callable:
    """Softmax cross entropy over ``{"images": NHWC, "labels": int}``
    batches: the mean NLL of the f32 log-softmax of ``model``'s logits."""

    def loss_fn(params, batch):
        logits = apply(model, params, batch["images"])
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -logprobs.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()

    return loss_fn
