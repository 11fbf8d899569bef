"""Pipeline-parallel LM training on the GPipe schedule over the mesh's
``pipe`` axis (the port's counterpart of ``examples/pipeline_lm.py``).

The pipeline LM (:mod:`autodist_tpu_torch.models.pipeline_lm`: d512 x 8 by
default, 8 heads, d_ff 2,048, vocab 32,000) trained under ``Pipeline``: the
block stacks shard over ``pipe`` (``--n_stages``), each rank runs its stage
on ``--microbatches`` micro-batches handed on with one hop a tick, and data
parallelism fills the other ranks. Adam 1e-3 on a synthetic global batch of
``--batch_size`` sequences; bf16 activations on the card, f32 on the host
(``--dtype`` sets them).
It needs ``--n_stages`` (at least 2) ranks or a multiple of them, one
process each:

    torchrun --standalone --nproc_per_node 4 -m autodist_tpu_torch.examples.pipeline_lm
    torchrun --standalone --nproc_per_node 4 -m autodist_tpu_torch.examples.pipeline_lm \\
        --n_stages 2                                   # data 2 x pipe 2
    torchrun --standalone --nproc_per_node 2 -m autodist_tpu_torch.examples.pipeline_lm \\
        --device cpu --n_stages 2 --batch_size 4 --seq_len 16 --d_model 32 \\
        --n_layers 2 --microbatches 2 --vocab 128 --steps 2     # the host, gloo

The batch is laid out on the device once. Rank 0 prints the JAX example's
result line (``pipeline: final loss ...; average ... tokens/sec (mesh=...)``,
here with each card's peak memory).
"""

import argparse
from typing import Optional, Sequence

import torch

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.examples.benchmark.common import is_rank0, peak_bytes_by_rank
from autodist_tpu_torch.models import pipeline_lm
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.strategy import Pipeline
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.metrics import ThroughputMeter


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=8)
    parser.add_argument("--n_stages", type=int, default=4)
    parser.add_argument("--microbatches", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="activation dtype (default: bfloat16 on the card, float32 on "
                             "the host)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train ``--steps`` steps; rank 0 prints the result line. Returns
    ``{"tokens_per_sec", "final_loss", "max_memory_allocated", "mesh"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = pipeline_lm.PipelineLMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=8, n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=args.seq_len + 1, n_stages=args.n_stages,
        num_microbatches=args.microbatches,
        dtype=getattr(torch, args.dtype or ("bfloat16" if on_card else "float32")))
    model, params = pipeline_lm.init_params(cfg, seed=0, device=device)
    batch = pipeline_lm.synthetic_batch(cfg, args.batch_size, args.seq_len)
    ad = AutoDist(args.resource_spec, strategy_builder=Pipeline(n_stages=args.n_stages),
                  device=device)
    step = ad.function(pipeline_lm.make_loss_fn(model), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8), example_batch=batch)
    runner = step.runner
    resident = runner.shard_batch(batch)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    meter = ThroughputMeter(batch_size=args.batch_size * args.seq_len,
                            log_every=args.log_every)
    loss = None
    for i in range(args.steps):
        loss = step(resident)
        rate = meter.step(sync=loss)
        if rate is not None and is_rank0():
            print(f"step {i + 1}: {rate:.1f} tokens/sec")
    final = float(loss)
    average = meter.finish() or 0.0
    peaks = peak_bytes_by_rank(device)
    mesh = {a: n for a, n in runner.plan.mesh_axes.items() if n > 1}
    if is_rank0():
        print(f"pipeline: final loss {final:.4f}; average {average:.1f} tokens/sec "
              f"(mesh={mesh})" + (f"; max_memory_allocated {peaks} bytes by rank" if on_card else ""))
    return {"tokens_per_sec": average, "final_loss": final, "max_memory_allocated": peaks,
            "mesh": mesh}


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
