"""Framework-free baseline: a bare PyTorch training loop, no AutoDist (the
port's counterpart of ``examples/benchmark/raw_jax_baseline.py``).

The "no-framework program" side of each CNN row's two-sided check: if this
rate matches the ImageNet benchmark's step
(:mod:`autodist_tpu_torch.examples.benchmark.imagenet`), the distance to
peak belongs to the model and PyTorch's kernels, not to the strategy
machinery. The same models (``build_model``), dtype (bf16 on the card, f32
on the host), optimizer (SGD 0.01, momentum 0.9) and synthetic batch, kept
on the device; each step is ``loss.backward()`` and ``opt.step()``. 3
warm-up steps, then ``--steps`` timed ones, the last loss read back as the
fence. MFU is per card against the H100's 989 TFLOP/s by the benchmark's
own ``FlopCounterMode`` count; on the host it is not measured.

    python -m autodist_tpu_torch.examples.benchmark.raw_torch_baseline --model resnet50 \\
        --batch_size 128
    # tiny, on the host:
    python -m autodist_tpu_torch.examples.benchmark.raw_torch_baseline --device cpu \\
        --model resnet50 --stages 1,1 --image_size 32 --batch_size 2 --steps 2
"""

import argparse
import time
from typing import Optional, Sequence

import torch

from autodist_tpu_torch.examples.benchmark import imagenet
from autodist_tpu_torch.examples.benchmark.common import card_mfu
from autodist_tpu_torch.models.common import make_classification_loss_fn
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

WARMUP_STEPS = 3
NUM_CLASSES = 1000


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="densenet121",
                        choices=["resnet50", "vgg16", "densenet121", "inceptionv3"])
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--stages", type=str, default="",
                        help="resnet only: residual blocks per stage, as the ImageNet "
                             "benchmark's --stages (a bring-up knob)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    args.stages = tuple(int(s) for s in args.stages.split(",")) if args.stages else ()
    args.norm = "group"                               # the benchmark's default
    if args.model == "inceptionv3":
        args.image_size = max(args.image_size, 299)   # the V3 stem needs >= 299
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, print the rate (and MFU on the card) and return them."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, make_params = imagenet.build_model(args, NUM_CLASSES, dtype)
    params = {k: v.requires_grad_() for k, v in make_params(device).items()}
    loss_fn = make_classification_loss_fn(model)
    opt = torch.optim.SGD(list(params.values()), lr=0.01, momentum=0.9)
    batch = {k: torch.as_tensor(v).to(device) for k, v in
             imagenet.synthetic_batch(NUM_CLASSES, args.batch_size, args.image_size).items()}

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(WARMUP_STEPS):
        loss = step()
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    final = float(loss)                 # the read-back is the completion fence
    rate = args.batch_size * args.steps / (time.perf_counter() - t0)
    print(f"raw-torch {args.model} bs{args.batch_size}: {rate:,.1f} examples/sec")
    per_step, mfu = card_mfu(lambda: flops_util.loss_and_grad_flops(loss_fn, params, batch),
                             rate / args.batch_size, device)
    return {"model": args.model, "batch_size": args.batch_size, "images_per_sec": rate,
            "final_loss": final, "flops_per_step": per_step, "mfu": mfu}


if __name__ == "__main__":
    main()
