"""The decoder scaling table on one card (the port's counterpart of
``examples/scale_lm.py``): the flagship's step at a bigger decoder.

    python -m autodist_tpu_torch.examples.scale_lm --d_model 768 --n_layers 12 --batch_size 192
    python -m autodist_tpu_torch.examples.scale_lm --d_model 1024 --n_layers 12 --batch_size 128
    python -m autodist_tpu_torch.examples.scale_lm --d_model 1024 --n_layers 24 --batch_size 96
    # tiny, on the host (the plain head):
    python -m autodist_tpu_torch.examples.scale_lm --device cpu --d_model 64 --n_layers 2 \\
        --batch_size 8 --seq_len 64 --vocab 256 --steps 2

TransformerLM with ``n_heads = d_model / 64``, ``d_ff = 4 d_model``,
``max_len = seq_len``, an untied head, dot attention; ``AllReduce`` and Adam
1e-3; bf16 activations and f32 params on the card, f32 on the host. The
head is the fused one on the card (its kernels are built for d_model 512,
768 and 1,024; another width raises there) and the plain logits head on the
host, where the JAX script's ``mosaic_compiles()`` decides the same. Two
warm-up steps, then ``--steps`` timed ones fenced by reading the loss back;
it prints the JAX script's line (tokens/s) and, on the card, the MFU line
(the analytic decoder count against the H100's 989 TFLOP/s).
"""

import argparse
import time
from typing import Optional, Sequence

import torch

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

WARMUP_STEPS = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--d_model", type=int, default=768)
    parser.add_argument("--n_layers", type=int, default=12)
    parser.add_argument("--batch_size", type=int, default=192)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--vocab", type=int, default=32_000)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def model_config(args: argparse.Namespace, on_card: bool) -> transformer_lm.TransformerLMConfig:
    """The JAX script's decoder at ``args``' size; bf16 activations and the
    fused head on the card, f32 and the plain head on the host."""
    return transformer_lm.TransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=max(1, args.d_model // 64),
        n_layers=args.n_layers, d_ff=4 * args.d_model, max_len=args.seq_len,
        dtype=torch.bfloat16 if on_card else torch.float32, tied_output=False,
        remat=args.remat, fused_head=on_card)


def build(args: argparse.Namespace):
    """``(config, step, batch)``: the ``AutoDist.function`` step with fresh
    weights from seed 0 and the synthetic batch resident on the device."""
    device = resolve_device(args.device)
    cfg = model_config(args, device.type == "cuda")
    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    batch = transformer_lm.synthetic_batch(cfg, args.batch_size, args.seq_len)
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    step = ad.function(transformer_lm.make_loss_fn(model), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8), example_batch=batch)
    step.n_params = sum(t.numel() for t in params.values())
    return cfg, step, step.runner.shard_batch(batch)


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train; print the result line (and the MFU on the card); return tokens/s."""
    args = parse_args(argv)
    cfg, step, batch = build(args)
    for _ in range(WARMUP_STEPS):
        loss = step(batch)
    float(loss)                  # the warm-up steps have run
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(batch)
    final = float(loss)
    dt = time.perf_counter() - t0

    tokens_per_step = args.batch_size * args.seq_len
    rate = tokens_per_step * args.steps / dt
    print(f"d{cfg.d_model}x{cfg.n_layers} bs{args.batch_size} seq{args.seq_len} "
          f"({step.n_params / 1e6:.0f}M params): final loss {final:.4f}, "
          f"{rate:,.0f} tokens/sec")
    if step.runner.device.type == "cuda":
        fpt = flops_util.transformer_flops_per_token(
            cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size, args.seq_len)
        flops_util.report_mfu(fpt * tokens_per_step / step.runner.plan.num_devices,
                              rate / tokens_per_step)
    else:
        print("mfu not measured (the host has no peak to divide by)")
    return rate


if __name__ == "__main__":
    main()
