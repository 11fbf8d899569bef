"""BERT pretraining benchmark with examples/s, MFU and peak memory (the port's
counterpart of ``examples/benchmark/bert.py``).

The masked-LM objective under ``AllReduce(compressor="HorovodCompressor")``
(the bf16 gradient codec) with AdamW 1e-4 (weight decay 1e-4, optax's
default), ``--size`` tiny, base or large. Input is synthetic with the
fixed-prediction-slot layout and resident on the card, or real:
``--tokenize_corpus`` turns a text corpus into raw MLM shards under
``--data_dir`` and exits; ``--data_dir`` then trains from them with a fresh
80/10/10 mask per batch (:class:`~autodist_tpu_torch.data.mlm.MLMBatcher`)
streamed through the device feed. ``--eval`` makes one deterministic pass
over ``--data_dir`` (the weights of ``--restore``, a ``Saver`` checkpoint, or
a fresh init) and prints the masked-LM accuracy.

    python -m autodist_tpu_torch.examples.benchmark.bert                     # the card
    python -m autodist_tpu_torch.examples.benchmark.bert --size base --batch_size 2048 \\
        --accum 8
    python -m autodist_tpu_torch.examples.benchmark.bert --tokenize_corpus 'corpus/*.txt' \\
        --data_dir mlm/
    python -m autodist_tpu_torch.examples.benchmark.bert --data_dir mlm/
    python -m autodist_tpu_torch.examples.benchmark.bert --data_dir mlm/ --eval \\
        --restore ckpt/model.ckpt-10
    # tiny, on the host:
    python -m autodist_tpu_torch.examples.benchmark.bert --device cpu --size tiny \\
        --batch_size 4 --seq_len 16 --max_predictions 4 --steps 2

Activations are bf16 on the card and f32 on the host, params f32. MFU is per
card against the H100's 989 TFLOP/s, from a ``FlopCounterMode`` count of one
micro-batch's matmuls times the micro-batches a step (each runs eagerly, so
the count is the whole step's work once); on the host it is not measured.
"""

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AutoDist, const
from autodist_tpu_torch.data import mlm, text_corpus
from autodist_tpu_torch.examples.benchmark.common import card_mfu, is_rank0, timed_steps
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

SIZES = {
    "tiny": dict(d_model=128, n_heads=2, n_layers=2, d_ff=512),
    "base": dict(d_model=768, n_heads=12, n_layers=12, d_ff=3072),
    "large": dict(d_model=1024, n_heads=16, n_layers=24, d_ff=4096),
}


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", choices=list(SIZES), default="base")
    parser.add_argument("--steps", type=int, default=110)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="global batch; 0 = 8 per device")
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--max_predictions", type=int, default=20)
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation micro-batches per step "
                             "(global batch = --batch_size; must divide it)")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="train from MLM token shards (prepared by "
                             "--tokenize_corpus) with dynamic masking; "
                             "default = synthetic batches")
    parser.add_argument("--tokenize_corpus", type=str, default=None,
                        help="text file/glob: prepare raw MLM shards into "
                             "--data_dir and exit")
    parser.add_argument("--vocab_size", type=int, default=30000,
                        help="corpus-built vocab budget for --tokenize_corpus")
    parser.add_argument("--segments", action="store_true",
                        help="prep with [CLS] a [SEP] b [SEP] segment pairs")
    parser.add_argument("--eval", action="store_true",
                        help="one deterministic pass over --data_dir: "
                             "masked-LM accuracy")
    parser.add_argument("--restore", type=str, default=None,
                        help="checkpoint prefix to evaluate (Saver format)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    if args.tokenize_corpus and not args.data_dir:
        parser.error("--tokenize_corpus needs --data_dir")
    if args.eval and not args.data_dir:
        parser.error("--eval needs --data_dir")
    return args


def tokenize(args) -> dict:
    """Build the vocabulary from the corpus and write the raw MLM shards."""
    vocab = text_corpus.build_vocab(args.tokenize_corpus, max_size=args.vocab_size)
    paths = mlm.prepare_mlm_shards(args.tokenize_corpus, vocab, args.data_dir,
                                   seq_len=args.seq_len, segments=args.segments)
    print(f"prepared {len(paths['tokens'])} MLM shard(s) in {args.data_dir}; train with "
          f"--data_dir {args.data_dir}")
    return paths


@dataclasses.dataclass
class Bench:
    """What :func:`build` made: the step, a batch source, and the pieces
    the run closes or reports from."""
    args: argparse.Namespace
    model: bert.Bert
    loss_fn: object
    step: object
    next_batch: object
    batch_size: int
    n_dev: int
    example: dict
    loader: object = None
    feed: object = None

    def close(self):
        if self.feed is not None:
            self.feed.close()       # stop the producer before its loader goes away
        if self.loader is not None:
            self.loader.close()


def build(args) -> Bench:
    """The training (or, with ``--eval``, the evaluation) step and its batch
    source, as ``main`` runs them."""
    device = resolve_device(args.device)
    n_dev = const.ENV.WORLD_SIZE.val or 1
    batch_size = args.batch_size or 8 * n_dev
    size_kw = dict(SIZES[args.size])
    loader = batcher = example = None
    if args.data_dir:
        # Eval is one deterministic pass: a sequential read, seeded masking.
        loader, meta = mlm.open_mlm_loader(args.data_dir, batch_size=batch_size,
                                           shuffle=not args.eval, prefetch=4)
        if meta["seq_len"] != args.seq_len:
            loader.close()
            raise ValueError(f"corpus was prepared at seq_len {meta['seq_len']}, got "
                             f"--seq_len {args.seq_len}")
        batcher = mlm.MLMBatcher(loader, vocab_size=meta["vocab_size"],
                                 max_predictions=args.max_predictions)
        size_kw["vocab_size"] = meta["vocab_size"]
        example = batcher.next()
    cfg = bert.BertConfig(max_len=args.seq_len, **size_kw,
                          dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    if example is None:
        example = bert.synthetic_batch(cfg, batch_size, args.seq_len,
                                       n_predictions=args.max_predictions)
    if args.eval and args.restore:
        # The restore replaces the params wholesale: no fresh init.
        from autodist_tpu_torch.checkpoint.saver import Saver
        model, params = bert.Bert(cfg), Saver().restore_params(args.restore)
    else:
        model, params = bert.init_params(cfg, seed=0, device=device)
    loss_fn = bert.make_mlm_loss_fn(model)
    ad = AutoDist(args.resource_spec, AllReduce(compressor="HorovodCompressor"),
                  device=device)
    if args.eval:
        step = ad.function(loss_fn, params, lambda p: torch.optim.SGD(p, lr=0.0),
                           example_batch=example)
    else:
        # optax.adamw's weight decay is 1e-4 (torch's AdamW defaults to 1e-2).
        step = ad.function(loss_fn, params,
                           lambda p: torch.optim.AdamW(p, lr=1e-4, weight_decay=1e-4),
                           example_batch=example, accumulation_steps=args.accum)
    bench = Bench(args, model, loss_fn, step, None, batch_size, n_dev, example, loader)
    if args.eval:
        bench.next_batch = batcher.next
    elif batcher is not None:
        # Masked batches stream through the device feed: the copy to the
        # card overlaps the running step.
        from autodist_tpu_torch.data.loader import device_prefetch
        bench.feed = device_prefetch(batcher, step.runner, depth=2)
        bench.next_batch = lambda: next(bench.feed)
    else:
        # Synthetic data stays on the card: re-sending it every step would
        # measure the host link, not the card.
        resident = step.runner.shard_batch(example)
        bench.next_batch = lambda: resident
    return bench


def evaluate(bench: Bench) -> float:
    """One pass over the shards: the masked-LM accuracy (argmax at every
    weighted slot)."""
    args, step, model = bench.args, bench.step, bench.model
    state = step.get_state()

    def metric_fn(p, b):
        logits = bert.apply(model, p, b["tokens"], b["token_types"], b["mlm_positions"])
        pred = logits.float().argmax(-1)
        w = b["mlm_weights"].float()
        return torch.stack([((pred == b["mlm_targets"].long()) * w).sum(), w.sum()])

    n_rows = bench.loader.n_rows
    n_batches = n_rows // bench.batch_size
    counts = np.zeros(2)
    for i in range(n_batches):
        # The example batch already took the first rows (sequential in eval).
        b = bench.example if i == 0 else bench.next_batch()
        counts += step.runner.evaluate(state, b, fn=metric_fn).cpu().numpy()
    skipped = n_rows - n_batches * bench.batch_size
    if skipped:
        print(f"WARNING: {skipped} tail row(s) skipped (static batch shapes drop the "
              f"remainder); pick a --batch_size dividing {n_rows} for exact coverage")
    acc = counts[0] / max(counts[1], 1)
    print(f"bert-{args.size} eval ({int(counts[1])} masked positions over "
          f"{n_batches * bench.batch_size}/{n_rows} rows): masked_lm_accuracy {acc:.4f}")
    return float(acc)


def train(bench: Bench) -> dict:
    """``--steps`` steps: examples/s over the whole mesh after one warm-up
    step, MFU and peak memory per card."""
    args, step = bench.args, bench.step
    avg, final, peak = timed_steps(step, bench.next_batch, bench.batch_size, args.steps,
                                   args.log_every)
    src = "disk" if args.data_dir else "synthetic"
    if is_rank0():
        print(f"bert-{args.size} ({src}): final loss {final:.4f}, {avg:.1f} examples/sec"
              + (f", max_memory_allocated {peak} bytes" if peak is not None else ""))
    # One micro-batch of this rank's rows, counted once for each micro-batch.
    micro = {k: v[:bench.batch_size // args.accum] for k, v in bench.example.items()}
    per_step, mfu = card_mfu(lambda: args.accum * flops_util.loss_and_grad_flops(
        bench.loss_fn, step.runner.logical_params(step.get_state()),
        step.runner.shard_batch(micro, accumulation=1)),
        avg / bench.batch_size, step.runner.device)
    return {"model": f"bert-{args.size}", "source": src, "batch_size": bench.batch_size,
            "accum": args.accum, "examples_per_sec": avg, "final_loss": final,
            "max_memory_allocated": peak, "flops_per_step": per_step, "mfu": mfu}


def main(argv: Optional[Sequence[str]] = None):
    """Tokenize, evaluate or train; a training run returns its result dict."""
    args = parse_args(argv)
    if args.tokenize_corpus:
        tokenize(args)
        return 0
    bench = build(args)
    try:
        if args.eval:
            return evaluate(bench)
        return train(bench)
    finally:
        bench.close()


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
