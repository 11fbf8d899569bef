"""Mixture-of-Experts Transformer LM, the expert-parallel workload
(counterpart of ``autodist_tpu/models/moe.py``).

Switch (top-1) routing with a static capacity per expert, as dense einsums
against one-hot dispatch and combine tensors; the expert FFN weights carry a
leading expert dimension, which the ``ExpertParallel`` strategy shards over
the mesh's ``expert`` axis. Tokens beyond an expert's capacity are dropped:
their dispatch row is all zeros, so they pass through the residual only.

Built on the ``meta`` device and applied to a flat ``{state-dict key:
tensor}`` dict, as :mod:`autodist_tpu_torch.models.transformer_lm` is, under
the JAX tree's names (``block_0.moe.experts_in``,
``block_0.moe.router.kernel``, ...) and layouts. What the port keeps from the
JAX model, since each changes the numbers:

- routing (:func:`switch_route`) runs in f32 on f32 router logits: a token's
  place in its expert's queue is a cumulative sum over the sequence axis of
  its batch row, so capacity is counted per row; the argmax breaks ties to
  the first expert; the aux loss is ``E * sum(frac_routed * mean_prob)``,
  whose means run over the global batch under data parallelism
  (:func:`~autodist_tpu_torch.parallel.synchronization.global_mean`);
  dispatch and combine are cast to the compute dtype before the einsums;
- the expert GELU is the tanh approximation (flax's ``nn.gelu``);
- the banks are initialized as flax's ``lecun_normal`` on ``[E, m, f]``
  draws them: the expert axis counts as receptive field, a fan-in of ``m * E``.

Expert parallelism (an ``expert`` axis of k > 1 ranks on the current mesh,
the banks arriving as this rank's ``[E/k, ...]`` storage): each rank runs
attention, the router, the routing and the aux loss on its rows whole, and
the FFN einsums on its own experts only; the partial outputs are summed over
the expert group. Two autograd functions carry the gradients: the sum's
backward is the identity (every rank holds the whole output's gradient),
and the FFN's inputs (``h`` and ``combine``) pass through an identity whose
backward sums the ranks' partial gradients, so the router and everything
before it see the whole gradient, once, on every expert rank.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch import const
from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import HEAD_KERNEL, fused_lm_head_nll
from autodist_tpu_torch.models.transformer_lm import (Dense, Embed, LayerNorm,
                                                      MultiHeadAttention,
                                                      TransformerLMConfig, _param,
                                                      causal_mask)
from autodist_tpu_torch.parallel.mesh import current_mesh, is_fake
from autodist_tpu_torch.parallel.synchronization import global_mean


@dataclasses.dataclass(frozen=True)
class MoETransformerLMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 1024
    n_experts: int = 8
    capacity_factor: float = 1.25    # capacity = ceil(tokens/expert * factor)
    router_aux_weight: float = 1e-2  # Switch load-balancing loss weight
    dtype: torch.dtype = torch.bfloat16
    # The fused head and loss kernels (ops/fused_xent): no logits in memory.
    fused_head: bool = False

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_experts < 2:
            raise ValueError("n_experts must be >= 2")

    def attn_config(self) -> TransformerLMConfig:
        """The dense attention sub-config reused from the dense LM."""
        return TransformerLMConfig(
            vocab_size=self.vocab_size, d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff, max_len=self.max_len,
            dtype=self.dtype, tied_output=False)


def switch_route(logits: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing with static capacity.

    logits: ``[B, S, E]`` router scores. Returns (dispatch ``[B, S, E, C]``
    one-hot, combine ``[B, S, E, C]`` = dispatch * router probability,
    aux_loss scalar), all f32. Overflow tokens get all-zero dispatch rows."""
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)                               # [B, S]
    assignment = F.one_hot(expert_idx, n_experts).float()
    # Position of each token within its expert's queue, in sequence order.
    position = torch.cumsum(assignment, dim=1) * assignment - 1.0   # [B, S, E]
    in_capacity = (position >= 0) & (position < capacity)
    slot = F.one_hot(position.clamp(0, capacity - 1).long(), capacity).float()
    dispatch = (assignment * in_capacity)[..., None] * slot
    top_prob = probs.max(dim=-1).values                             # [B, S]
    combine = dispatch * top_prob[..., None, None]
    # Switch aux loss: E * sum_e(fraction routed to e * mean router prob of
    # e), both means over every data rank's rows, as over the JAX package's
    # data-sharded batch.
    tokens = torch.tensor(float(logits.shape[0] * logits.shape[1]), device=logits.device)
    frac_routed = global_mean(assignment.sum(dim=(0, 1)), tokens)
    mean_prob = global_mean(probs.sum(dim=(0, 1)), tokens)
    aux = n_experts * torch.sum(frac_routed * mean_prob)
    return dispatch, combine, aux


def expert_ffn(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
               w_in: torch.Tensor, w_out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The FFN of the experts whose banks are ``w_in [e, m, f]`` and
    ``w_out [e, f, m]``, over their ``e`` columns of ``dispatch`` and
    ``combine`` (``[B, S, e, C]``): each token's output from those experts,
    ``[B, S, m]`` (its whole output when they are all the experts)."""
    expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, x)
    h = F.gelu(torch.einsum("ebcm,emf->ebcf", expert_in, w_in.to(dtype)), approximate="tanh")
    expert_out = torch.einsum("ebcf,efm->ebcm", h, w_out.to(dtype))
    return torch.einsum("bsec,ebcm->bsm", combine, expert_out)


class _SumOverExperts(torch.autograd.Function):
    """The experts' partial outputs summed over the expert group; the
    backward is the identity (the output's gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        if not is_fake(y):
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ExpertGradSum(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the expert group:
    each rank's FFN sees its own experts only, so its gradient of a
    replicated input is partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if not is_fake(g):
            dist.all_reduce(g, group=ctx.group)
        return g, None


def _sharded_ffn(x, dispatch, combine, w_in, w_out, dtype):
    """:func:`expert_ffn` over every expert: here when the banks are whole,
    else this rank's ``[E/k, ...]`` shard of them with the partial outputs
    summed over the current mesh's expert group."""
    n_experts, local = dispatch.shape[2], w_in.shape[0]
    if local == n_experts:
        return expert_ffn(x, dispatch, combine, w_in, w_out, dtype)
    mesh = current_mesh()
    k = mesh.shape.get(const.MESH_AXIS_EXPERT, 1) if mesh is not None else 1
    if local * k != n_experts:
        raise ValueError(f"expert banks of {local} experts on an expert axis of {k} ranks "
                         f"do not make the router's {n_experts}")
    group = mesh.group((const.MESH_AXIS_EXPERT,))
    lo = mesh.coords[const.MESH_AXIS_EXPERT] * local
    x = _ExpertGradSum.apply(x, group)
    combine = _ExpertGradSum.apply(combine, group)
    y = expert_ffn(x, dispatch[:, :, lo:lo + local], combine[:, :, lo:lo + local],
                   w_in, w_out, dtype)
    return _SumOverExperts.apply(y, group)


class MoEFFN(nn.Module):
    """Route, run each token's expert, return: ``x [B, S, m] -> (y, aux)``."""

    def __init__(self, cfg: MoETransformerLMConfig):
        super().__init__()
        self.cfg = cfg
        self.router = Dense((cfg.d_model,), (cfg.n_experts,), torch.float32)
        # Expert banks: the leading expert dim is what ExpertParallel shards.
        self.experts_in = _param(cfg.n_experts, cfg.d_model, cfg.d_ff)
        self.experts_out = _param(cfg.n_experts, cfg.d_ff, cfg.d_model)

    def forward(self, x):
        cfg = self.cfg
        capacity = int(np.ceil(x.shape[1] * cfg.capacity_factor / cfg.n_experts)) or 1
        dispatch, combine, aux = switch_route(self.router(x), capacity)
        y = _sharded_ffn(x, dispatch.to(cfg.dtype), combine.to(cfg.dtype),
                         self.experts_in, self.experts_out, cfg.dtype)
        return y, aux


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoETransformerLMConfig):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg.attn_config())
        self.ln_moe = LayerNorm(cfg.d_model, cfg.dtype)
        self.moe = MoEFFN(cfg)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_attn(x), mask)
        y, aux = self.moe(self.ln_moe(x))
        return x + y, aux


class MoETransformerLM(nn.Module):
    """Decoder-only LM with an MoE FFN in every block: ``tokens -> (logits,
    aux_loss)``, or ``(hidden, aux_loss)`` with ``return_hidden``."""

    def __init__(self, config: MoETransformerLMConfig):
        super().__init__()
        self.config = cfg = config
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", MoEBlock(cfg))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = Dense((cfg.d_model,), (cfg.vocab_size,), cfg.dtype)

    def forward(self, tokens, return_hidden: bool = False):
        cfg = self.config
        length = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[:length][None].to(cfg.dtype)
        mask = causal_mask(length, cfg.dtype, device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, aux = getattr(self, f"block_{i}")(x, mask)
            aux_total = aux_total + aux
        x = self.ln_f(x)
        if return_hidden:
            # The fused-head loss owns the projection.
            return x, aux_total / cfg.n_layers
        return self.lm_head(x), aux_total / cfg.n_layers


def make_loss_fn(model: MoETransformerLM) -> Callable:
    """Next-token cross entropy + the router's load-balancing aux loss."""
    cfg = model.config

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if cfg.fused_head:
            h, aux = layers.apply(model, params, inputs, return_hidden=True)
            nll = fused_lm_head_nll(h, {HEAD_KERNEL: params[HEAD_KERNEL]}, targets)
            return nll.mean() + cfg.router_aux_weight * aux
        logits, aux = layers.apply(model, params, inputs)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        nll = -logprobs.gather(-1, targets[..., None])[..., 0]
        return nll.mean() + cfg.router_aux_weight * aux

    return loss_fn


def init_params(config: MoETransformerLMConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[MoETransformerLM, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's initializers
    (:func:`~autodist_tpu_torch.models.layers.init_params`; the expert banks
    ``lecun_normal`` with a fan-in of ``m * E``) from a generator seeded with
    ``seed``. The values differ from the JAX package's: feed both the same
    weights through ``from_jax_params``."""
    model = MoETransformerLM(config)
    return model, layers.init_params(model, seed, device)


def synthetic_batch(config: MoETransformerLMConfig, batch_size: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, config.vocab_size,
                                  size=(batch_size, seq_len + 1)).astype(np.int32)}

