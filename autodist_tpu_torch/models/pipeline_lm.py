"""Pipeline-parallel Transformer LM over the mesh ``pipe`` axis (counterpart
of ``autodist_tpu/models/pipeline_lm.py``).

A functional transformer whose block weights are stacked along a leading
layer dimension: the ``Pipeline`` strategy shards that dimension over
``pipe``, so each rank stores and runs a contiguous group of layers, and the
forward streams micro-batches through
:func:`~autodist_tpu_torch.parallel.pipeline.pipelined` (GPipe). The
embedding, the final norm and the head stay replicated across the pipe ranks.
:func:`make_onef_oneb_value_and_grad` is the same model's training step on the
1F1B schedule (interleaved with ``n_chunks > 1``), a library function of the
surface ``f(params, batch) -> (loss, grads)``, as in the JAX package.

``params`` is the flat dict of the JAX tree's paths (``embed``, ``pos``,
``blocks.wqkv``, ..., ``ln_f_s``, ``ln_f_b``, ``head``) in the JAX layouts,
so ``from_jax_params`` carries JAX weights across. On pipe ranks the
``blocks.*`` leaves the model reads are this rank's ``[L/S, ...]`` rows. What
the port keeps from the JAX model, since each changes the numbers: the layer
norm's f32 statistics with eps 1e-6; dot attention whose bf16 scores are
divided by an f32 ``sqrt(hd)`` (so they turn f32), the ``-1e9`` causal mask
and an f32 softmax; the tanh GELU; an f32 head.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.pipeline import (chunk_perm, gather_stages,
                                                  interleaved_value_and_grad, pipelined,
                                                  pipelined_value_and_grad)
from autodist_tpu_torch.utils.device import resolve_device

BLOCKS = "blocks."
TAIL = ("ln_f_s", "ln_f_b", "head")


@dataclasses.dataclass(frozen=True)
class PipelineLMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_len: int = 1024
    n_stages: int = 4
    num_microbatches: int = 4
    # Interleaved 1F1B: each rank runs n_chunks virtual stages (layer groups
    # c mod n_stages == rank); 1 = plain contiguous stages (GPipe / 1F1B).
    n_chunks: int = 1
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_layers % (self.n_stages * self.n_chunks):
            raise ValueError("n_layers must be divisible by n_stages * n_chunks")
        if self.n_chunks > 1 and self.num_microbatches % self.n_stages:
            raise ValueError(
                "interleaved schedule (n_chunks > 1) needs num_microbatches "
                "divisible by n_stages")


def _layer_norm(x, scale, bias):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-6)
    return (y * scale + bias).to(x.dtype)


def _block_apply(p, x, config: PipelineLMConfig):
    """One pre-LN transformer block; ``p`` holds this layer's weights."""
    b, t, d = x.shape
    hd = d // config.n_heads
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    q, k, v = (h @ p["wqkv"].to(x.dtype)).split(d, dim=-1)
    q, k, v = (a.reshape(b, t, config.n_heads, hd) for a in (q, k, v))
    # An f32 divisor, as the JAX model's numpy f32 scalar: the scores turn f32.
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / float(np.float32(np.sqrt(hd)))
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, scores, torch.full((), -1e9, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
    x = x + ctx @ p["wo"].to(x.dtype)
    h = _layer_norm(x, p["ln2_s"], p["ln2_b"])
    h = F.gelu(h @ p["w1"].to(x.dtype), approximate="tanh")
    return x + h @ p["w2"].to(x.dtype)


def _blocks(params) -> Dict[str, torch.Tensor]:
    return {k[len(BLOCKS):]: v for k, v in params.items() if k.startswith(BLOCKS)}


# Forward pieces shared by PipelineLM.apply (GPipe + autograd) and
# make_onef_oneb_value_and_grad (1F1B): one definition each.

def _embed_microbatches(cfg: PipelineLMConfig, params, tokens):
    """Embedding + positions, ``[B, T, D] -> [M, B/M, T, D]`` (micro-batch k
    is rows k, k + M, ...: data sharding stays on the micro-batch rows)."""
    b, t = tokens.shape
    m = cfg.num_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by num_microbatches {m}")
    x = params["embed"][tokens].to(cfg.dtype)
    x = x + params["pos"][None, :t, :].to(cfg.dtype)
    return x.reshape(b // m, m, t, cfg.d_model).swapaxes(0, 1)


def _stage_groups(cfg: PipelineLMConfig, blocks, n_groups: Optional[int] = None):
    """Block stacks ``[rows, ...] -> [rows / lps, lps, ...]``, ``lps`` the
    layers of one of ``n_groups`` stage groups (default n_stages; the
    interleaved path passes S v): the whole stack's groups, or a pipe rank's.
    A stack that does not split so is passed on as it is, for the schedule's
    mesh and leading-dim checks to name."""
    lps = cfg.n_layers // (cfg.n_stages if n_groups is None else n_groups)
    return {k: a.reshape(-1, lps, *a.shape[1:]) if a.shape[0] % lps == 0 else a
            for k, a in blocks.items()}


def layer_execution_order(cfg: PipelineLMConfig):
    """``order[stored_row] = execution_position`` of the block stack: the
    identity at ``n_chunks == 1``; with ``n_chunks > 1`` blocks are stored in
    device-major chunk order (stored group ``r v + j`` holds execution group
    ``j S + r``: :func:`~autodist_tpu_torch.parallel.pipeline.chunk_perm`
    expanded from groups to layers), so a rank's ``P("pipe")`` rows are its
    chunks with no per-step layout traffic. A checkpoint written under one
    ``(n_stages, n_chunks)`` restores bit for bit only into the same; move
    between configs through :func:`blocks_to_execution_order` /
    :func:`blocks_from_execution_order`."""
    lps = cfg.n_layers // (cfg.n_stages * cfg.n_chunks)
    order = []
    for c in chunk_perm(cfg.n_stages, cfg.n_chunks):   # stored g reads virtual c
        order.extend(range(c * lps, (c + 1) * lps))
    return order


def blocks_to_execution_order(cfg: PipelineLMConfig, blocks):
    """Stored (device-major) block stack -> execution-order stack (the
    config-independent layout)."""
    inv = torch.from_numpy(np.argsort(np.asarray(layer_execution_order(cfg))))
    return {k: a[inv.to(a.device)] for k, a in blocks.items()}


def blocks_from_execution_order(cfg: PipelineLMConfig, blocks):
    """Execution-order block stack -> this config's stored layout."""
    idx = torch.tensor(layer_execution_order(cfg))
    return {k: a[idx.to(a.device)] for k, a in blocks.items()}


def _make_stage_fn(cfg: PipelineLMConfig) -> Callable:
    def stage_fn(p, xb):
        p = {k: a[0] for k, a in p.items()}          # drop the stage dim
        for i in range(next(iter(p.values())).shape[0]):
            xb = _block_apply({k: a[i] for k, a in p.items()}, xb, cfg)
        return xb
    return stage_fn


def _head_logits(tail_params, y):
    h = _layer_norm(y, tail_params["ln_f_s"], tail_params["ln_f_b"])
    return h.float() @ tail_params["head"]


def _nll(logits, targets):
    logprobs = torch.log_softmax(logits, dim=-1)
    return -logprobs.gather(-1, targets[..., None])[..., 0]


class PipelineLM:
    """Functional model object: ``apply(params, tokens) -> logits``."""

    def __init__(self, config: PipelineLMConfig):
        self.config = config

    def apply(self, params, tokens):
        """The GPipe forward over the current mesh's ``pipe`` ranks."""
        cfg = self.config
        b, t = tokens.shape
        x_mb = _embed_microbatches(cfg, params, tokens)
        blocks = _blocks(params)
        if cfg.n_chunks > 1:
            # GPipe needs contiguous execution-order stage groups; with
            # device-major storage that costs one gather of the stack over
            # the pipe ranks here (the GPipe comparison path), keeping the
            # 1F1B training step permute-free.
            whole, rank = gather_stages(blocks) if next(iter(blocks.values())).shape[0] \
                != cfg.n_layers else (blocks, None)
            blocks = blocks_to_execution_order(cfg, whole)
            if rank is not None:
                rows = cfg.n_layers // cfg.n_stages
                blocks = {k: a[rank * rows:(rank + 1) * rows] for k, a in blocks.items()}
        y_mb = pipelined(_make_stage_fn(cfg), cfg.n_stages,
                         axis=const.MESH_AXIS_PIPE)(_stage_groups(cfg, blocks), x_mb)
        h = y_mb.swapaxes(0, 1).reshape(b, t, cfg.d_model)
        return _head_logits(params, h)


def make_loss_fn(model: PipelineLM) -> Callable:
    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        return _nll(model.apply(params, inputs), targets).mean()

    return loss_fn


def make_onef_oneb_value_and_grad(model: PipelineLM) -> Callable:
    """The model's training step on the 1F1B schedule: ``f(params, batch) ->
    (loss, grads)`` with a gradient for every parameter (keyed as
    ``params``). The embedding and positions run replicated before the
    pipeline (their gradient returns through the schedule's input gradient),
    the stacked blocks run as the stages, and the final norm, head and loss
    are the in-schedule tail at the last stage. With ``n_chunks > 1`` the
    interleaved schedule runs over the device-major stored stack, with no
    layout permute in the step."""
    cfg = model.config

    def f(params, batch):
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, t = inputs.shape
        m = cfg.num_microbatches
        with torch.enable_grad():
            pre = {k: params[k].detach().requires_grad_() for k in ("embed", "pos")}
            x_mb = _embed_microbatches(cfg, pre, inputs)
        targets_mb = targets.reshape(b // m, m, t).swapaxes(0, 1)
        tail_params = {k: params[k] for k in TAIL}

        def tail_fn(tp, y, tgt):
            return _nll(_head_logits(tp, y), tgt).mean()

        blocks = _blocks(params)
        if cfg.n_chunks > 1:
            n_groups = cfg.n_stages * cfg.n_chunks
            loss, gs, gt, gx = interleaved_value_and_grad(
                _make_stage_fn(cfg), tail_fn, cfg.n_stages, cfg.n_chunks,
                axis=const.MESH_AXIS_PIPE)(_stage_groups(cfg, blocks, n_groups),
                                           tail_params, x_mb.detach(), targets_mb)
        else:
            loss, gs, gt, gx = pipelined_value_and_grad(
                _make_stage_fn(cfg), tail_fn, cfg.n_stages, axis=const.MESH_AXIS_PIPE)(
                    _stage_groups(cfg, blocks), tail_params, x_mb.detach(), targets_mb)
        d_embed, d_pos = torch.autograd.grad(x_mb, [pre["embed"], pre["pos"]],
                                             gx.to(x_mb.dtype))
        grads = {"embed": d_embed, "pos": d_pos}
        grads.update({BLOCKS + k: g.reshape(-1, *g.shape[2:]) for k, g in gs.items()})
        grads.update(gt)
        return loss, {k: grads[k] for k in params}

    return f


def init_params(config: PipelineLMConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[PipelineLM, Dict[str, torch.Tensor]]:
    """``(model, params)``: the JAX package's initializers (normal draws at
    its scales, norms at 1 and 0) from a generator seeded with ``seed``. The
    values differ from the JAX package's: feed both the same weights
    through ``from_jax_params``."""
    cfg = config
    g = torch.Generator().manual_seed(seed)
    d, f, n, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=g)

    params = {
        "embed": normal((v, d), 0.02),
        "pos": normal((cfg.max_len, d), 0.02),
        "blocks.ln1_s": torch.ones(n, d), "blocks.ln1_b": torch.zeros(n, d),
        "blocks.wqkv": normal((n, d, 3 * d), d ** -0.5),
        "blocks.wo": normal((n, d, d), d ** -0.5),
        "blocks.ln2_s": torch.ones(n, d), "blocks.ln2_b": torch.zeros(n, d),
        "blocks.w1": normal((n, d, f), d ** -0.5),
        "blocks.w2": normal((n, f, d), f ** -0.5),
        "ln_f_s": torch.ones(d), "ln_f_b": torch.zeros(d),
        "head": normal((d, v), d ** -0.5),
    }
    device = resolve_device(device)
    return PipelineLM(cfg), {k: a.to(device) for k, a in params.items()}


def sequential_apply(model: PipelineLM, params, tokens):
    """The forward without the pipeline (the reference of the schedules):
    the same math, a plain layer loop in execution order."""
    cfg = model.config
    t = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    x = x + params["pos"][None, :t, :].to(cfg.dtype)
    blocks = _blocks(params)
    if cfg.n_chunks > 1:
        blocks = blocks_to_execution_order(cfg, blocks)
    for i in range(cfg.n_layers):
        x = _block_apply({k: a[i] for k, a in blocks.items()}, x, cfg)
    x = _layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x.float() @ params["head"]


def synthetic_batch(config: PipelineLMConfig, batch_size: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, config.vocab_size,
                                  size=(batch_size, seq_len + 1)).astype(np.int32)}
