"""Mixture-of-Experts LM training with expert parallelism (the port's
counterpart of ``examples/moe_lm.py``).

The MoE LM (:mod:`autodist_tpu_torch.models.moe`: d512 x 4 by default, 8
heads, d_ff 2,048, 8 experts, Switch top-1 routing, vocab 32,000) trained
under ``ExpertParallel``, with Adam 1e-3 on a synthetic global batch of
``--batch_size`` sequences (``--accum`` micro-batches a step). The expert
banks shard over the mesh's ``expert`` axis (``--expert_axis``, -1 = the
largest divisor of the device count and the expert count) and the other
devices fill ``data``. On the card the activations are bf16 and the head and
loss run through the fused head's kernels (the JAX example turns its fused
head on for any compiling backend); on the host, f32 and their plain
versions.

    python -m autodist_tpu_torch.examples.moe_lm                 # one card
    torchrun --standalone --nproc_per_node 4 -m autodist_tpu_torch.examples.moe_lm \\
        --batch_size 512 --accum 4 --expert_axis 4               # 4 cards (NCCL)
    python -m autodist_tpu_torch.examples.moe_lm --device cpu --batch_size 4 \\
        --seq_len 16 --d_model 32 --n_layers 1 --vocab 128 --steps 2

The batch is laid out on the device once. Rank 0 prints the JAX example's
result line (``moe: final loss ...; average ... tokens/sec (mesh=...)``,
here with each card's peak memory) and on the card its MFU line (analytic
FLOPs with one active expert a token, per card, against the H100's 989
TFLOP/s).
"""

import argparse
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.examples.benchmark.common import is_rank0, peak_bytes_by_rank
from autodist_tpu_torch.models import moe
from autodist_tpu_torch.strategy import ExpertParallel
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.metrics import ThroughputMeter


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=4)
    parser.add_argument("--n_experts", type=int, default=8)
    parser.add_argument("--expert_axis", type=int, default=-1,
                        help="-1 = auto (largest divisor of devices and experts)")
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation micro-batches per step "
                             "(global batch = --batch_size; must divide it)")
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def build(args: argparse.Namespace):
    """``(config, step, batch)``: the ``AutoDist.function`` step over fresh
    weights from seed 0, and the synthetic global batch laid out on the device."""
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = moe.MoETransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=8, n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=args.seq_len + 1, n_experts=args.n_experts,
        dtype=torch.bfloat16 if on_card else torch.float32, fused_head=on_card)
    model, params = moe.init_params(cfg, seed=0, device=device)
    batch = moe.synthetic_batch(cfg, args.batch_size, args.seq_len)
    ad = AutoDist(args.resource_spec, strategy_builder=ExpertParallel(
        num_experts=args.n_experts, expert_axis_size=args.expert_axis), device=device)
    step = ad.function(moe.make_loss_fn(model), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                       example_batch=batch, accumulation_steps=args.accum)
    return cfg, step, step.runner.shard_batch(batch)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train ``--steps`` steps; rank 0 prints the result (and MFU) lines.
    Returns ``{"tokens_per_sec", "final_loss", "mfu", "max_memory_allocated",
    "mesh"}``."""
    args = parse_args(argv)
    cfg, step, batch = build(args)
    runner = step.runner
    on_card = runner.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(runner.device)
    tokens_per_step = args.batch_size * args.seq_len
    meter = ThroughputMeter(batch_size=tokens_per_step, log_every=args.log_every)
    loss = None
    for i in range(args.steps):
        loss = step(batch)
        rate = meter.step(sync=loss)
        if rate is not None and is_rank0():
            print(f"step {i + 1}: {rate:.1f} tokens/sec")
    final = float(loss)
    average = meter.finish() or 0.0
    peaks = peak_bytes_by_rank(runner.device)
    mesh = {a: n for a, n in runner.plan.mesh_axes.items() if n > 1} or {"data": 1}
    mfu = None
    if is_rank0():
        print(f"moe: final loss {final:.4f}; average {average:.1f} tokens/sec "
              f"(mesh={mesh})" + (f"; max_memory_allocated {peaks} bytes by rank" if on_card else ""))
        # Switch top-1 routing runs one expert's FFN a token; per card, as
        # the JAX example counts it.
        fpt = flops_util.transformer_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff,
                                                     cfg.vocab_size, args.seq_len)
        if on_card:
            mfu = flops_util.report_mfu(fpt * tokens_per_step / runner.plan.num_devices,
                                        average / tokens_per_step)
        else:
            print("mfu not measured (the host has no peak to divide by)")
    return {"tokens_per_sec": average, "final_loss": final, "mfu": mfu,
            "max_memory_allocated": peaks, "mesh": mesh}


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
