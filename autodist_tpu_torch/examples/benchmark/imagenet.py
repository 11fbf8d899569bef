"""ImageNet-class CNN benchmark with images/s, MFU and peak memory (the
port's counterpart of ``examples/benchmark/imagenet.py``).

The model by ``--model`` (ResNet-50 by default; ResNet-101, VGG16,
DenseNet-121, Inception-v3), the strategy by ``--strategy``, with the JAX
example's per-model ``AllReduce`` chunk sizes (``CHUNK_SIZES``). The global
batch defaults to 32 images a card. Input is synthetic and resident on the
card, or real: ``--prep_images`` decodes a ``<class>/<file>`` tree into uint8
record shards under ``--data_dir`` and exits; ``--data_dir`` then trains
from them, augmenting on the card, either from the record pool on the card
(``--input_mode cache``) or streaming full batches through the device feed
(``stream``). ``--eval`` makes one deterministic pass with the eval
preprocessing and prints top-1 and top-5 accuracy.

    python -m autodist_tpu_torch.examples.benchmark.imagenet                # the card
    python -m autodist_tpu_torch.examples.benchmark.imagenet --strategy PSLoadBalancing \\
        --batch_size 128
    torchrun --standalone --nproc_per_node 4 -m autodist_tpu_torch.examples.benchmark.imagenet
    # tiny, on the host:
    python -m autodist_tpu_torch.examples.benchmark.imagenet --device cpu --stages 1,1 \\
        --image_size 32 --batch_size 4 --steps 2

Activations are bf16 on the card and f32 on the host, params f32. MFU is
per card, against the H100's 989 TFLOP/s, from a ``FlopCounterMode`` count
of one step's matmuls and convolutions (:func:`~autodist_tpu_torch.utils.
flops.loss_and_grad_flops`); on the host it is not measured. The run info
and the examples/s metrics go through
:mod:`~autodist_tpu_torch.utils.benchmark_logger` (files under
``$AUTODIST_BENCHMARK_LOG_DIR`` when it is set), as in the JAX example.
"""

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AutoDist, const
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.data import imagenet as imagenet_data
from autodist_tpu_torch.examples.benchmark.common import card_mfu, is_rank0, timed_steps
from autodist_tpu_torch.models import densenet, inception, layers, resnet, vgg
from autodist_tpu_torch.models.common import make_classification_loss_fn
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.benchmark_logger import gather_run_info, get_benchmark_logger
from autodist_tpu_torch.utils.device import resolve_device

# The reference's chunk sizes (vgg16=25, resnet101=200, inceptionv3=30,
# others 512); resnet50 takes resnet101's.
CHUNK_SIZES = {"vgg16": 25, "resnet50": 200, "resnet101": 200, "inceptionv3": 30,
               "default": 512}


def build_strategy(name: str, model_name: str):
    chunk = CHUNK_SIZES.get(model_name, CHUNK_SIZES["default"])
    return {
        "PS": lambda: strategies.PS(),
        "PSLoadBalancing": lambda: strategies.PSLoadBalancing(),
        "PartitionedPS": lambda: strategies.PartitionedPS(),
        "AllReduce": lambda: strategies.AllReduce(chunk_size=chunk),
        "Parallax": lambda: strategies.Parallax(chunk_size=chunk),
    }[name]()


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="resnet50",
                        choices=["resnet50", "resnet101", "vgg16", "densenet121",
                                 "inceptionv3"])
    parser.add_argument("--strategy", default="AllReduce",
                        choices=["PS", "PSLoadBalancing", "PartitionedPS", "AllReduce",
                                 "Parallax"])
    parser.add_argument("--steps", type=int, default=110)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="global batch; 0 = 32 per device")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation micro-batches per step "
                             "(global batch = --batch_size; must divide it)")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="train from image record shards (prepared by "
                             "--prep_images); default = synthetic input")
    parser.add_argument("--prep_images", type=str, default=None,
                        help="<class>/<file> image tree: decode into uint8 record "
                             "shards under --data_dir and exit")
    parser.add_argument("--record_size", type=int, default=256,
                        help="stored record side for --prep_images (crop source; "
                             "must exceed --image_size)")
    parser.add_argument("--pool_rows", type=int, default=0,
                        help="cache mode: record-pool rows on the card (0 = auto, "
                             "capped by DeviceDatasetCache's memory budget)")
    parser.add_argument("--eval", action="store_true",
                        help="one pass over --data_dir with the eval preprocessing "
                             "(center crop, no flip): top-1/top-5 accuracy")
    parser.add_argument("--restore", type=str, default=None,
                        help="checkpoint prefix to evaluate (Saver format); "
                             "default = fresh init (chance accuracy)")
    parser.add_argument("--norm", choices=["group", "batch"], default="group",
                        help="resnet normalization: group (pure function) or batch "
                             "(cross-replica sync-BN, no running statistics: --eval "
                             "then normalizes with the eval batch's own moments "
                             "unless --bn_ema calibrates stored statistics first)")
    parser.add_argument("--bn_ema", type=int, default=0, metavar="N",
                        help="--eval --norm batch only: run N train-preprocessed "
                             "calibration batches first, EMA each SyncBatchNorm "
                             "site's (mean, var) into a bn_ema collection outside "
                             "params, and evaluate with those statistics")
    parser.add_argument("--stages", type=str, default="",
                        help="resnet only: residual blocks per stage, comma-separated, "
                             "overriding the model's (resnet50=3,4,6,3): a bring-up "
                             "knob; rates compare only at the default depth")
    parser.add_argument("--input_mode", choices=["cache", "stream"], default="cache",
                        help="--data_dir feed: 'cache' = record pool on the card with "
                             "background refresh; 'stream' = full batches through "
                             "the device feed every step")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    if args.prep_images and not args.data_dir:
        parser.error("--prep_images needs --data_dir")
    if args.eval and not args.data_dir:
        parser.error("--eval needs --data_dir")
    if args.bn_ema and not (args.eval and args.norm == "batch"
                            and args.model in ("resnet50", "resnet101")):
        parser.error("--bn_ema needs --eval and a resnet with --norm batch")
    if args.stages:
        try:
            args.stages = tuple(int(s) for s in args.stages.split(","))
            if not args.stages or any(s < 1 for s in args.stages):
                raise ValueError
        except ValueError:
            parser.error(f"--stages needs comma-separated positive integers, "
                         f"got {args.stages!r}")
    if args.model == "inceptionv3":
        args.image_size = max(args.image_size, 299)     # the V3 stem needs >= 299
    return args


def build_model(args, num_classes: int, dtype: torch.dtype, seed: int = 0):
    """``(model, make-params function)`` for ``--model``; the params are
    drawn only when the function is called (an eval restore needs none)."""
    if args.model in ("resnet50", "resnet101"):
        stages = args.stages or ((3, 4, 23, 3) if args.model == "resnet101" else (3, 4, 6, 3))
        model = resnet.ResNet(resnet.ResNet50Config(num_classes=num_classes, dtype=dtype,
                                                    stage_sizes=stages, norm=args.norm))
    elif args.model == "densenet121":
        model = densenet.DenseNet(densenet.DenseNet121Config(num_classes=num_classes,
                                                             dtype=dtype))
    elif args.model == "inceptionv3":
        model = inception.InceptionV3(inception.InceptionV3Config(num_classes=num_classes,
                                                                  dtype=dtype))
    else:
        model = vgg.VGG16(num_classes=num_classes, dtype=dtype, image_size=args.image_size)
    return model, lambda device: layers.init_params(model, seed, device)


def synthetic_batch(num_classes: int, batch_size: int, image_size: int):
    rng = np.random.RandomState(0)
    return {"images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
            "labels": rng.randint(0, num_classes, size=(batch_size,)).astype(np.int32)}


@dataclasses.dataclass
class Bench:
    """What :func:`build` made: the step, a batch source, and the pieces
    the run closes or reports from."""
    args: argparse.Namespace
    model: torch.nn.Module
    loss_fn: object
    step: object
    next_batch: object
    batch_size: int
    n_dev: int
    example: object
    loader: object = None
    feed: object = None

    def close(self):
        if self.feed is not None:
            self.feed.close()       # stop the producer before its loader goes away
        if self.loader is not None:
            self.loader.close()


def build(args) -> Bench:
    """The training step (``AutoDist.function``, SGD 0.01 with momentum
    0.9) and its batch source, as ``main`` runs them."""
    device = resolve_device(args.device)
    n_dev = const.ENV.WORLD_SIZE.val or 1
    batch_size = args.batch_size or 32 * n_dev
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    num_classes, loader, cache, batcher, meta = 1000, None, None, None, None
    if args.data_dir:
        # Eval is one deterministic pass: sequential, center crop, no flip.
        loader, meta = imagenet_data.open_image_loader(
            args.data_dir, batch_size=batch_size, shuffle=not args.eval, prefetch=4)
        if meta["record_size"] < args.image_size:
            raise ValueError(f"records are {meta['record_size']}px, smaller than "
                             f"--image_size {args.image_size}")
        num_classes = len(meta["classes"])
        if args.eval or args.input_mode == "stream":
            batcher = imagenet_data.AugmentingBatcher(
                loader, image_size=args.image_size, record_size=meta["record_size"],
                train=not args.eval)
        else:
            cache = imagenet_data.DeviceDatasetCache(
                loader, record_size=meta["record_size"], image_size=args.image_size,
                dtype=dtype, pool_rows=args.pool_rows or None, device=device)
    model, make_params = build_model(args, num_classes, dtype)
    if args.eval and args.restore:
        from autodist_tpu_torch.checkpoint.saver import Saver
        params = Saver().restore_params(args.restore)
    else:
        params = make_params(device)
    loss_fn = make_classification_loss_fn(model)
    if batcher is not None:
        # Stream mode: raw uint8 records, augmented inside the step.
        loss_fn = imagenet_data.make_augmented_loss_fn(model, args.image_size, dtype)
        example = batcher.next()
    elif cache is not None:
        example = cache.next_batch(batch_size)
    else:
        example = synthetic_batch(num_classes, batch_size, args.image_size)
    ad = AutoDist(args.resource_spec, build_strategy(args.strategy, args.model),
                  device=device)
    lr = 0.0 if args.eval else 0.01
    step = ad.function(loss_fn, params,
                       lambda p: torch.optim.SGD(p, lr=lr, momentum=0.0 if args.eval else 0.9),
                       example_batch=example, accumulation_steps=args.accum)
    bench = Bench(args, model, loss_fn, step, None, batch_size, n_dev, example, loader)
    if cache is not None:
        bench.next_batch = lambda: cache.next_batch(batch_size)
    elif batcher is not None:
        if not args.eval:
            from autodist_tpu_torch.data.loader import device_prefetch
            bench.feed = device_prefetch(batcher, step.runner, depth=2)
            bench.next_batch = lambda: next(bench.feed)
        else:
            bench.next_batch = batcher.next
    else:
        # Synthetic data stays on the card for the whole run: re-sending it
        # every step would measure the host link, not the card.
        resident = step.runner.shard_batch(example)
        bench.next_batch = lambda: resident
    return bench


def evaluate(bench: Bench) -> float:
    """One pass over the records with the eval preprocessing: top-1 (printed
    with top-5)."""
    args, step, model = bench.args, bench.step, bench.model
    state = step.get_state()
    dtype = torch.bfloat16 if step.runner.device.type == "cuda" else torch.float32
    bn_stats = eval_model = None
    if args.bn_ema:
        cal_loader, meta = imagenet_data.open_image_loader(
            args.data_dir, batch_size=bench.batch_size, shuffle=True, prefetch=2)
        cal = imagenet_data.AugmentingBatcher(cal_loader, image_size=args.image_size,
                                              record_size=meta["record_size"], train=True)

        def images():
            for _ in range(args.bn_ema):
                b = cal.next()
                yield imagenet_data.augment_images(
                    torch.as_tensor(b["images"]).to(step.runner.device), b["crop_yx"],
                    b["flip"], args.image_size, dtype)

        bn_stats = resnet.calibrate_bn_ema(model, step.runner.logical_params(state), images())
        cal_loader.close()
        eval_model = resnet.ResNet(dataclasses.replace(model.config, bn_ema=True))
        print(f"calibrated SyncBatchNorm EMA over {args.bn_ema} batch(es); evaluating "
              f"with stored statistics")

    def metric_fn(p, b):
        x = imagenet_data.augment_images(b["images"], b["crop_yx"], b["flip"],
                                         args.image_size, dtype)
        if bn_stats is not None:
            logits = resnet.apply(eval_model, p, x, bn_ema=bn_stats)
        else:
            logits = layers.apply(model, p, x)
        logits = logits.float()
        top5 = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
        labels = b["labels"].long()
        c1 = (logits.argmax(-1) == labels).sum()
        c5 = (top5 == labels[:, None]).any(-1).sum()
        return torch.stack([c1, c5])

    n_batches = bench.loader.n_rows // bench.batch_size
    counts = np.zeros(2)
    for i in range(n_batches):
        # The example batch already took the first rows (sequential in eval).
        b = bench.example if i == 0 else bench.next_batch()
        counts += step.runner.evaluate(state, b, fn=metric_fn).cpu().numpy()
    seen = n_batches * bench.batch_size
    skipped = bench.loader.n_rows - seen
    if skipped:
        print(f"WARNING: {skipped} tail example(s) skipped (static batch shapes drop "
              f"the remainder); pick a --batch_size dividing {bench.loader.n_rows} for "
              f"exact coverage")
    top1, top5 = counts / max(seen, 1)
    print(f"{args.model} eval ({seen}/{bench.loader.n_rows} examples, center crop "
          f"{args.image_size}): top-1 {top1:.4f}  top-5 {top5:.4f}")
    return float(top1)


def main(argv: Optional[Sequence[str]] = None):
    """Prepare, evaluate or train; a training run returns its result dict
    (images/s over the whole mesh, MFU and peak memory per card)."""
    args = parse_args(argv)
    if args.prep_images:
        paths = imagenet_data.prepare_image_shards(args.prep_images, args.data_dir,
                                                   record_size=args.record_size)
        print(f"prepared {len(paths['images'])} image shard(s) in {args.data_dir}; train "
              f"with --data_dir {args.data_dir}")
        return 0
    bench = build(args)
    try:
        if args.eval:
            return evaluate(bench)
        return train(bench)
    finally:
        bench.close()


def train(bench: Bench) -> dict:
    args, step = bench.args, bench.step
    bench_logger = get_benchmark_logger()
    bench_logger.log_run_info(gather_run_info(args.model, strategy_name=args.strategy,
                                              batch_size=bench.batch_size))
    # A failed step still records run_status and closes the metric file.
    try:
        avg, final, peak = timed_steps(step, bench.next_batch, bench.batch_size, args.steps,
                                       args.log_every, logger=bench_logger)
        bench_logger.log_metric("average_examples_per_second", avg, unit="examples/s",
                                global_step=args.steps)
    except BaseException:
        bench_logger.on_finish(status="failure")
        raise
    bench_logger.on_finish()
    src = "disk" if args.data_dir else "synthetic"
    if is_rank0():
        print(f"{args.model}/{args.strategy} ({src}): final loss {final:.4f}, {avg:.1f} "
              f"examples/sec ({avg / max(bench.n_dev, 1):.1f}/device)"
              + (f", max_memory_allocated {peak} bytes" if peak is not None else ""))
    per_step, mfu = card_mfu(lambda: flops_util.loss_and_grad_flops(
        bench.loss_fn, step.runner.logical_params(step.get_state()),
        step.runner.shard_batch(bench.next_batch(), accumulation=1)),
        avg / bench.batch_size, step.runner.device)
    return {"model": args.model, "strategy": args.strategy, "source": src,
            "batch_size": bench.batch_size, "images_per_sec": avg, "final_loss": final,
            "max_memory_allocated": peak, "flops_per_step": per_step, "mfu": mfu}


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
