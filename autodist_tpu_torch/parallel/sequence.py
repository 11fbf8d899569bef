"""Sequence (context) parallelism: the training path over the ``seq`` mesh
axis (counterpart of ``autodist_tpu/parallel/sequence.py``).

The sequence dimension of the batch is sharded over the ranks of the seq
group, one process per card; each rank runs the model on its shard with

- globally offset position embeddings (rank r's shard starts at position
  ``r * L_local``),
- ring attention for the mixing across shards (K/V rotate around the group,
  :mod:`autodist_tpu_torch.parallel.ring_attention`), or Ulysses (two
  all-to-alls re-shard by heads around flash attention,
  :mod:`autodist_tpu_torch.parallel.ulysses`), and
- the loss as this shard's share of the global token mean (local NLL sum over
  the token count all-reduced over the data and seq ranks, as the JAX loss
  psums over both), whose gradients the runner combines over the same ranks
  (:func:`autodist_tpu_torch.parallel.synchronization.make_grad_fn`),
  where the JAX package's ``psum`` transposes inside ``shard_map``.

Sequence parallelism composes with data parallelism in one mesh: the ring
runs on the seq sub-group of each data rank's ranks. A group of ``None`` is
a ring of one rank: the same path without sends.
"""

from typing import Callable, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import multihost
from autodist_tpu_torch.parallel.mesh import joined_mesh
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.parallel.ring_attention import ring_size_and_rank
from autodist_tpu_torch.parallel.synchronization import SYNC_AXES, global_mean
from autodist_tpu_torch.runner import DistributedRunner


def make_sequence_parallel_loss_fn(model: tlm.TransformerLM,
                                   group: Optional[dist.ProcessGroup] = None) -> Callable:
    """``loss_fn(params, batch)``: next-token cross entropy with the sequence
    sharded over ``group``, the seq ranks. ``model`` uses ring or Ulysses
    attention (``attention_impl`` "ring" or "ulysses"); every other layer
    is positionwise, which is what makes per-shard evaluation exact.
    ``batch = {"tokens": int [B, L+1]}``, the whole sequence on every rank,
    with L divisible by the group's size.

    The returned loss has the global token mean over the data and seq ranks
    as its value on every rank and this shard's share of it as its gradient
    (scaled as :func:`~autodist_tpu_torch.parallel.synchronization.global_mean`
    says). Outside a runner's step the mean is over ``group``."""
    size, rank = ring_size_and_rank(group)
    cfg = model.config

    def per_token_nll(params, inputs, targets, offset):
        if cfg.fused_head:
            return tlm.fused_head_nll(model, params, inputs, targets, pos_offset=offset,
                                      seq_group=group)
        logits = tlm.apply(model, params, inputs, pos_offset=offset, seq_group=group)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -logprobs.gather(-1, targets[..., None])[..., 0]

    def loss_fn(params, batch):
        tokens = batch["tokens"].long()
        # Shift globally BEFORE sharding, so shard r's last target is shard
        # r + 1's first input token.
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        length = inputs.shape[1]
        if length % size:
            raise ValueError(f"Sequence length {length} is not divisible by the seq "
                             f"axis ({size})")
        if length > cfg.max_len:
            # Checked globally: a shard alone cannot see that its offset runs
            # past the position table.
            raise ValueError(f"Global sequence length {length} exceeds the model's "
                             f"max_len ({cfg.max_len})")
        l_local = length // size
        shard = slice(rank * l_local, (rank + 1) * l_local)
        nll = per_token_nll(params, inputs[:, shard], targets[:, shard], rank * l_local)
        count = torch.tensor(float(nll.numel()), device=nll.device)
        return global_mean(nll.sum(), count, axes=SYNC_AXES, group=group)
    return loss_fn


def create_sequence_parallel_session(autodist, model: tlm.TransformerLM, params,
                                     optimizer: Callable):
    """Sequence-parallel counterpart of ``AutoDist.create_distributed_session``
    (``autodist_tpu/parallel/sequence.py:99-121``). ``autodist`` carries a
    strategy with a ``seq`` axis (:class:`~autodist_tpu_torch.strategy.SequenceParallel`);
    each rank calls this with the same arguments. With a mesh of more than
    one rank (seq, or data x seq) the process group is joined from
    torchrun's environment and must hold the mesh's ranks; the ring or the
    Ulysses exchange runs on this rank's seq sub-group."""
    model_spec = ModelSpec(params)
    compiled = autodist._compile(model_spec)
    plan = ShardingPlan.from_strategy(compiled, model_spec)
    if plan.num_devices > 1:
        multihost.maybe_initialize_multihost(autodist.device)
    mesh = joined_mesh(plan.mesh_axes)
    group = mesh.group((const.MESH_AXIS_SEQ,)) if mesh is not None else None
    loss_fn = make_sequence_parallel_loss_fn(model, group)
    return DistributedRunner(compiled, model_spec, loss_fn, optimizer, autodist.device,
                             plan=plan, mesh=mesh)
