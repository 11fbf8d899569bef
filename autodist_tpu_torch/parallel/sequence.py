"""Sequence (context) parallelism: the training path over the ``seq`` mesh
axis (counterpart of ``autodist_tpu/parallel/sequence.py``).

The sequence dimension of the batch is sharded over the ranks of the seq
group, one process per card; each rank runs the model on its shard with

- globally offset position embeddings (rank r's shard starts at position
  ``r * L_local``),
- ring attention for the mixing across shards (K/V rotate around the group,
  :mod:`autodist_tpu_torch.parallel.ring_attention`), and
- the loss as this shard's share of the global token mean (local NLL sum over
  the all-reduced token count), whose gradients the runner sums over the
  group (:func:`autodist_tpu_torch.parallel.synchronization.make_grad_fn`),
  where the JAX package's ``psum`` transposes inside ``shard_map``.

A group of ``None`` is a ring of one rank: the same path without sends.
"""

from typing import Callable, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import multihost
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.parallel.ring_attention import ring_size_and_rank
from autodist_tpu_torch.runner import DistributedRunner


def make_sequence_parallel_loss_fn(model: tlm.TransformerLM,
                                   group: Optional[dist.ProcessGroup] = None) -> Callable:
    """``loss_fn(params, batch)``: next-token cross entropy with the sequence
    sharded over ``group``. ``model`` uses ring attention
    (``attention_impl="ring"``); every other layer is positionwise, which is
    what makes per-shard evaluation exact. ``batch = {"tokens": int [B, L+1]}``,
    the whole sequence on every rank, with L divisible by the group's size.

    The returned loss has the global token mean as its value on every rank
    and this shard's share of it as its gradient."""
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
        sums = torch.stack([nll.detach().sum(), torch.tensor(float(nll.numel()),
                                                             device=nll.device)])
        if size > 1:
            dist.all_reduce(sums, group=group)
        local = nll.sum() / sums[1]
        # Value: the global mean; gradient: this shard's share of it.
        return local + (sums[0] / sums[1] - local).detach()

    loss_fn.sparse_names = model.gather_only_params()
    return loss_fn


def create_sequence_parallel_session(autodist, model: tlm.TransformerLM, params,
                                     optimizer: Callable):
    """Sequence-parallel counterpart of ``AutoDist.create_distributed_session``
    (``autodist_tpu/parallel/sequence.py:99-121``). ``autodist`` carries a
    strategy with a ``seq`` axis (:class:`~autodist_tpu_torch.strategy.SequenceParallel`);
    each rank calls this with the same arguments. With a seq axis of k > 1
    the process group is joined from torchrun's environment and must hold k
    ranks; at k = 1 no group is needed."""
    model_spec = ModelSpec(params)
    compiled = autodist._compile(model_spec)
    plan = ShardingPlan.from_strategy(compiled, model_spec)
    group = None
    if plan.seq_size > 1 and multihost.maybe_initialize_multihost(autodist.device):
        group = dist.group.WORLD
    loss_fn = make_sequence_parallel_loss_fn(model, group)
    return DistributedRunner(compiled, model_spec, loss_fn, optimizer, autodist.device,
                             plan=plan, seq_group=group)
