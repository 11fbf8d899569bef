"""Long-context LM training: flash attention + remat + fused head on one
card, or sequence parallelism with ring attention over k cards (counterpart
of ``examples/long_context_lm.py``).

    python -m autodist_tpu_torch.examples.long_context_lm --seq_len 8192
    # the sequence sharded over k cards, one process each (ring attention):
    torchrun --standalone --nproc_per_node 2 \\
        -m autodist_tpu_torch.examples.long_context_lm --seq_axis 2
    # a tiny run on the host, through the kernels' plain versions:
    python -m autodist_tpu_torch.examples.long_context_lm --device cpu \\
        --seq_len 64 --batch_size 2 --d_model 64 --n_layers 1 --vocab 256 --steps 2
    # the same sharded over two host processes (gloo):
    torchrun --standalone --nproc_per_node 2 \\
        -m autodist_tpu_torch.examples.long_context_lm --seq_axis 2 --device cpu \\
        --seq_len 64 --batch_size 2 --d_model 64 --n_layers 1 --vocab 256 --steps 2

It trains the flagship architecture (d_model 512, 6 layers, 8 heads, d_ff
4 * d_model, vocab 32,000, untied fused head) through
``AutoDist(strategy_builder=AllReduce()).function`` with Adam 1e-3, at seq
8,192 and a global batch of ``393_216 // seq_len`` sequences by default, with
every block rematerialized unless ``--no_remat``. Activations are bf16 on the
card and f32 on the host; parameters are f32.

- ``--attention auto`` (the default) is flash: the port's Hopper kernels on
  the card, their plain versions on the host.
- ``--seq_axis k`` with k > 1 trains through ``SequenceParallel(seq_axis_size=k)``
  and ``create_sequence_parallel_session``: each of k processes holds a
  1/k shard of every sequence and attention is ring attention across them
  (the Hopper carry kernel on the card). It takes no ``--attention`` other
  than ``auto``. Only rank 0 prints.
- ``--device`` defaults to the card (``cuda:$LOCAL_RANK`` under torchrun,
  else ``cuda:0``).

The speed figures in the JAX example's docstring were measured on a TPU v5e
and are not this port's; ``PERF.md`` records the card's.
"""

import argparse
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from autodist_tpu_torch import AllReduce, AutoDist, SequenceParallel
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.parallel.sequence import create_sequence_parallel_session
from autodist_tpu_torch.runner import step_function
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

ONE_CARD = {"nodes": [{"address": "localhost", "gpus": [0]}]}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seq_len", type=int, default=8192)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="global batch (default: fills to ~393k tokens)")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=6)
    parser.add_argument("--vocab", type=int, default=32_000)
    parser.add_argument("--attention", default="auto",
                        choices=["auto", "flash", "blockwise", "dot"])
    parser.add_argument("--seq_axis", type=int, default=0,
                        help=">1 shards the sequence over that many processes, one "
                             "per card (ring attention); launch with torchrun")
    parser.add_argument("--no_remat", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    if args.seq_axis > 1 and args.attention != "auto":
        parser.error(f"--seq_axis {args.seq_axis} shards the sequence and runs ring "
                     f"attention across shards; it cannot honor --attention "
                     f"{args.attention} (drop the flag)")
    return args


def model_config(args: argparse.Namespace) -> transformer_lm.TransformerLMConfig:
    """The model config for ``args``: ring attention under a seq axis, else
    ``--attention`` ("auto" is flash); bf16 on a card, f32 on the host."""
    if args.seq_axis > 1:
        attention = "ring"
    else:
        attention = "flash" if args.attention == "auto" else args.attention
    return transformer_lm.TransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=8,
        n_layers=args.n_layers, d_ff=4 * args.d_model, max_len=args.seq_len,
        dtype=torch.bfloat16 if resolve_device(args.device).type == "cuda" else torch.float32,
        tied_output=False, remat=not args.no_remat, attention_impl=attention,
        fused_head=True)


def build(args: argparse.Namespace) -> Tuple[transformer_lm.TransformerLMConfig, Callable,
                                             Dict[str, np.ndarray]]:
    """``(config, step, batch)``: the model config, the ``AutoDist.function``
    training step (``step(batch) -> loss``) with fresh weights from seed 0,
    and the synthetic batch the example trains on."""
    device = resolve_device(args.device)
    sequence_parallel = args.seq_axis > 1
    batch_size = args.batch_size or max(1, 393_216 // args.seq_len)
    cfg = model_config(args)
    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    batch = transformer_lm.synthetic_batch(cfg, batch_size=batch_size,
                                           seq_len=args.seq_len)
    optimizer = lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8)  # noqa: E731
    if sequence_parallel:
        cards = {"nodes": [{"address": "localhost", "gpus": list(range(args.seq_axis))}]}
        ad = AutoDist(resource_info=cards,
                      strategy_builder=SequenceParallel(seq_axis_size=args.seq_axis),
                      device=device)
        step = step_function(create_sequence_parallel_session(ad, model, params, optimizer),
                             params)
    else:
        ad = AutoDist(resource_info=ONE_CARD, strategy_builder=AllReduce(), device=device)
        step = ad.function(transformer_lm.make_loss_fn(model), params, optimizer,
                           example_batch=batch)
    return cfg, step, batch


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train, print the result line (and MFU on the card); returns tokens/s."""
    args = parse_args(argv)
    cfg, step, batch = build(args)
    batch_size, seq_len = batch["tokens"].shape[0], args.seq_len
    device = step.runner.device

    float(step(batch))                  # first step: kernel builds, allocator warm-up
    t0 = time.perf_counter()
    loss = None
    for _ in range(args.steps):
        loss = step(batch)
    final = float(loss) if loss is not None else float("nan")   # waits for the steps
    dt = time.perf_counter() - t0

    tokens_per_step = batch_size * seq_len
    rate = tokens_per_step * args.steps / dt
    if dist.is_initialized() and dist.get_rank() != 0:
        return rate
    print(f"long-context seq={seq_len} bs={batch_size} "
          f"attention={cfg.attention_impl} remat={cfg.remat} "
          f"(mesh={dict(step.runner.plan.mesh_axes)}): final loss {final:.4f}, "
          f"{rate:,.0f} tokens/sec")
    fpt = flops_util.transformer_flops_per_token(
        cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size, seq_len)
    if device.type == "cuda":
        # Per card: each of the mesh's cards does its share of the step.
        flops_util.report_mfu(fpt * tokens_per_step / step.runner.plan.num_devices,
                              rate / tokens_per_step)
    else:
        print("mfu not measured: the run was on the host, not the card")
    return rate


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
