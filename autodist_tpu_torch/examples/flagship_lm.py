"""The flagship training benchmark (the port's counterpart of the flagship in
``bench.py``): TransformerLM d512 x 6, 8 heads, d_ff 2048, vocab 32,000,
max_len 512, untied fused head, bf16 activations and f32 params, trained
with ``AllReduce`` (``--strategy`` names another builder of
:mod:`autodist_tpu_torch.strategy`, built with its defaults) and Adam 1e-3
on micro-batches of 384 sequences of 256 tokens per data rank with 8-way
gradient accumulation (a global batch of ``384 * dp * 8`` sequences).

    python -m autodist_tpu_torch.examples.flagship_lm   # one visible card
    # data parallelism over k cards, one process each (the mesh is every
    # visible card, so a lone process on a machine of several raises unless
    # CUDA_VISIBLE_DEVICES names one):
    torchrun --standalone --nproc_per_node k -m autodist_tpu_torch.examples.flagship_lm
    # a tiny run on the host, through the kernels' plain versions:
    python -m autodist_tpu_torch.examples.flagship_lm --device cpu --micro_batch 2 \\
        --seq_len 16 --accum 2 --d_model 64 --n_layers 1 --vocab 128 --steps 2

The batch is made resident on the device once (``step.runner.shard_batch``),
then 2 warm-up steps and ``--steps`` timed steps run, the last loss read back
as the fence. Rank 0 prints one JSON line with ``bench.py``'s keys
``metric``, ``value`` (tokens/s over the whole mesh), ``unit``,
``flops_per_token`` and ``mfu`` (analytic, per card, against the H100's
989 TFLOP/s), plus ``max_memory_allocated``, ``final_loss`` and
``strategy``; on the host ``mfu`` and the
memory are null, not measured. ``bench.py``'s ``vs_baseline`` is left out:
its baseline is a TPU figure.
"""

import argparse
import json
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

WARMUP_STEPS = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--micro_batch", type=int, default=384,
                        help="sequences per micro-batch per data rank")
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--accum", type=int, default=8)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=6)
    parser.add_argument("--vocab", type=int, default=32_000)
    parser.add_argument("--strategy", default="AllReduce",
                        help="a builder of autodist_tpu_torch.strategy, with its defaults "
                             "(PSLoadBalancing: the update sharded over every data rank)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def model_config(args: argparse.Namespace) -> transformer_lm.TransformerLMConfig:
    """The flagship's model config for ``args`` (bf16 on a card, f32 on the
    host)."""
    return transformer_lm.TransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=8, n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=512,
        dtype=torch.bfloat16 if resolve_device(args.device).type == "cuda" else torch.float32,
        tied_output=False, fused_head=True)


def build(args: argparse.Namespace, builder=None, resource_info: Optional[dict] = None,
          **session) -> Tuple[transformer_lm.TransformerLMConfig, Callable, object]:
    """``(config, step, batch)``: the ``AutoDist.function`` step with fresh
    weights from seed 0 and the synthetic global batch, already laid out on
    the device. The mesh is one data rank per process of the world.
    ``builder`` (a strategy builder instance) overrides ``--strategy``,
    ``resource_info`` the local default resource spec, and ``session``
    goes to ``AutoDist.function`` (``num_workers=``, ``zero=``); the
    ``AutoDist`` is ``step.autodist``."""
    device = resolve_device(args.device)
    cfg = model_config(args)
    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    if builder is None:
        builder = getattr(strategies, args.strategy)()
    # One micro-batch for the sparse walk (only its shapes and dtypes are
    # read), as bench.py passes its batch: at bf16 it marks pos_embed sparse.
    ad = AutoDist(resource_info=resource_info, strategy_builder=builder, device=device)
    step = ad.function(
        transformer_lm.make_loss_fn(model), params,
        lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
        example_batch=transformer_lm.synthetic_batch(cfg, args.micro_batch, args.seq_len),
        accumulation_steps=args.accum, **session)
    step.autodist = ad
    batch = transformer_lm.synthetic_batch(
        cfg, args.micro_batch * step.runner.plan.dp_size * args.accum, args.seq_len)
    # Device-resident batch: measure the card, not the host link.
    return cfg, step, step.runner.shard_batch(batch)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, print the JSON result line on rank 0 and return it."""
    args = parse_args(argv)
    cfg, step, batch = build(args)
    runner = step.runner
    n_dev = runner.plan.num_devices
    on_card = runner.device.type == "cuda"
    for _ in range(WARMUP_STEPS):
        loss = step(batch)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(batch)
    final = float(loss)          # the fence: the last loss needs every step
    dt = time.perf_counter() - t0

    global_batch = args.micro_batch * runner.plan.dp_size * args.accum
    tokens_per_sec = global_batch * args.seq_len * args.steps / dt
    flops_per_token = flops_util.transformer_flops_per_token(
        cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size, args.seq_len)
    mfu = flops_util.mfu(flops_per_token * tokens_per_sec / n_dev) if on_card else None
    result = {
        "metric": f"transformer_lm_train_tokens_per_sec ({'gpu' if on_card else 'cpu'} "
                  f"x{n_dev}, d{cfg.d_model}x{cfg.n_layers}, seq{args.seq_len}, "
                  f"bs{global_batch}={global_batch // args.accum}x{args.accum}accum)",
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/s",
        "flops_per_token": round(flops_per_token),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(runner.device)
                                 if on_card else None),
        "final_loss": final,
        "strategy": args.strategy,
    }
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
