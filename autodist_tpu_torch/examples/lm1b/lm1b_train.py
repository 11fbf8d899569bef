"""lm1b language-model training with words/sec (the port's counterpart of
``examples/lm1b/lm1b_train.py``).

``--model lstm`` is lm1b's model family (:mod:`autodist_tpu_torch.models.lstm_lm`:
embedding ``--d_model``, LSTM hidden ``2 * d_model``, ``--n_layers``) with
the sampled softmax over 1,024 host-drawn negatives, or with
``--full_softmax`` the exact softmax through the fused head (``"vd"``, with
the bias; the logits never exist, so ``--vocab 793471``, lm1b's real size,
trains). ``--model transformer`` is the decoder LM (d_model x n_layers, 8
heads, untied plain logits head). Both train under ``Parallax`` (dense
parameters all-reduced, the gathered tables to PS), with the optimizer of
``choose_optimizer`` (Adam 1e-3 when its moments fit the card, else
Adafactor) and its default batch: 128 sequences, 96 when it picks the
factored optimizer.

    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --model lstm       # the card
    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --model lstm --full_softmax \\
        --vocab 793471
    # corpus prep, then training from the token shards:
    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --write_synthetic_corpus 4096 \\
        --data_dir corpus/
    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --tokenize_corpus 'text/*' \\
        --vocab_file vocab.txt --data_dir corpus/
    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --model lstm --full_softmax \\
        --data_dir corpus/
    # tiny, on the host:
    python -m autodist_tpu_torch.examples.lm1b.lm1b_train --device cpu --model lstm \\
        --batch_size 4 --seq_len 8 --d_model 16 --n_layers 1 --vocab 128 --steps 2

Input is one synthetic batch resident on the device, or token shards
(``[rows, seq_len + 1]`` int32 ``.npy``) streamed through the native
``DataLoader`` and the device feed. Activations are bf16 on the card and f32
on the host (the LSTM's states are f32 either way). It prints a rate every
``--log_every`` steps, the final loss and the average words/s (target
tokens, after one warm-up step), and for the sampled and transformer paths
the MFU line (a ``FlopCounterMode`` count of one step's matmuls against the
H100's peak; not on the host), as the JAX script skips it for
``--full_softmax``.
"""

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.data import save_shards, text_corpus
from autodist_tpu_torch.examples.benchmark.common import card_mfu
from autodist_tpu_torch.models import lstm_lm, transformer_lm
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.strategy import Parallax
from autodist_tpu_torch.strategy.auto_strategy import choose_optimizer
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.metrics import ThroughputMeter


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=["transformer", "lstm"], default="transformer",
                        help="'lstm' = lm1b's model family (LSTM + sampled softmax)")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="0 = 128, or 96 when the optimizer choice is the factored one")
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=6)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--full_softmax", action="store_true",
                        help="LSTM only: the exact full-vocabulary softmax through the "
                             "fused head instead of the sampled one (trains at --vocab "
                             "793471, lm1b's real size)")
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--data_dir", type=str, default=None,
                        help="stream training tokens from tokens-*.npy shards in this "
                             "directory instead of a device-resident synthetic batch")
    parser.add_argument("--write_synthetic_corpus", type=int, default=0, metavar="ROWS",
                        help="write ROWS synthetic token rows as .npy shards into "
                             "--data_dir and exit")
    parser.add_argument("--tokenize_corpus", type=str, default=None, metavar="GLOB",
                        help="tokenize whitespace-split text files into token shards "
                             "under --data_dir and exit; word ids from --vocab_file or, "
                             "without one, a frequency vocabulary of --vocab built from the "
                             "corpus")
    parser.add_argument("--vocab_file", type=str, default=None,
                        help="vocabulary for --tokenize_corpus (a word in the first column "
                             "of each line, by frequency; unknown words share one bucket)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    args = parser.parse_args(argv)
    if args.full_softmax and args.model != "lstm":
        parser.error("--full_softmax applies to --model lstm")
    if (args.write_synthetic_corpus or args.tokenize_corpus) and not args.data_dir:
        parser.error("--write_synthetic_corpus and --tokenize_corpus need --data_dir")
    args.error = parser.error
    return args


def write_synthetic_corpus(args) -> dict:
    """``ROWS`` random token rows as shards, with the sidecar a tokenized
    corpus carries (so the training run's vocab and seq_len checks hold)."""
    rows = args.write_synthetic_corpus
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, args.vocab, size=(rows, args.seq_len + 1)).astype(np.int32)
    files = save_shards({"tokens": tokens}, args.data_dir, rows_per_shard=max(1, rows // 8))
    text_corpus.write_meta(args.data_dir, vocab_size=args.vocab, seq_len=args.seq_len,
                           rows=rows, stride=args.seq_len + 1, oov_buckets=0)
    print(f"wrote {rows} rows across {len(files['tokens'])} shards in {args.data_dir}")
    return files


def tokenize_corpus(args) -> list:
    """Known words cap at ``--vocab - 1``, so with the unknown-word bucket
    the vocabulary never exceeds ``--vocab``."""
    if args.vocab_file:
        vocab = text_corpus.load_vocab(args.vocab_file, max_size=max(1, args.vocab - 1))
    else:
        vocab = text_corpus.build_vocab(args.tokenize_corpus, max_size=max(1, args.vocab - 1))
    shards = text_corpus.tokenize_to_shards(args.tokenize_corpus, vocab, args.data_dir,
                                            seq_len=args.seq_len)
    print(f"tokenized corpus -> {len(shards)} shards in {args.data_dir}; train with "
          f"--data_dir {args.data_dir} --vocab {vocab.vocab_size} --seq_len {args.seq_len}")
    return shards


def build_model(args, device):
    """``(config, params, loss_fn)`` of ``--model``."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.model == "lstm":
        cfg = lstm_lm.LSTMLMConfig(vocab_size=args.vocab, emb_dim=args.d_model,
                                   hidden_dim=2 * args.d_model, n_layers=args.n_layers,
                                   dtype=dtype)
        model, params = lstm_lm.init_params(cfg, seed=0, device=device)
        loss_fn = (lstm_lm.make_fused_full_softmax_loss_fn(model) if args.full_softmax
                   else lstm_lm.make_loss_fn(model))
    else:
        cfg = transformer_lm.TransformerLMConfig(
            vocab_size=args.vocab, d_model=args.d_model, n_heads=8, n_layers=args.n_layers,
            d_ff=4 * args.d_model, max_len=args.seq_len + 1, dtype=dtype, tied_output=False)
        model, params = transformer_lm.init_params(cfg, seed=0, device=device)
        loss_fn = transformer_lm.make_loss_fn(model)
    return cfg, params, loss_fn


def open_feed(args, step):
    """``(loader, feed)`` over ``--data_dir``'s token shards, after the JAX
    script's checks: shards present, ``[rows, seq_len + 1]`` int32, and a
    corpus vocabulary no larger than ``--vocab``."""
    shards = sorted(glob.glob(os.path.join(glob.escape(args.data_dir), "tokens-*.npy")))
    if not shards:
        args.error(f"no tokens-*.npy shards under {args.data_dir} "
                   f"(--write_synthetic_corpus prepares one)")
    head = np.load(shards[0], mmap_mode="r")
    if head.ndim != 2 or head.dtype != np.int32:
        args.error(f"corpus shards must be [rows, seq_len+1] int32; {shards[0]} is "
                   f"{head.dtype} with {head.ndim} dims")
    if head.shape[1] != args.seq_len + 1:
        args.error(f"corpus rows are {head.shape[1]} tokens wide; the model needs "
                   f"seq_len+1 = {args.seq_len + 1}")
    meta = text_corpus.read_meta(args.data_dir)
    if meta and meta["vocab_size"] > args.vocab:
        args.error(f"corpus in {args.data_dir} was tokenized with vocab_size "
                   f"{meta['vocab_size']} (see tokens-meta.json) but the model has "
                   f"--vocab {args.vocab}; ids would gather out of range")
    from autodist_tpu_torch.data import DataLoader, device_prefetch
    loader = DataLoader(files={"tokens": shards}, batch_size=args.batch_size, shuffle=True)
    return loader, device_prefetch(loader, step.runner, depth=2)


def build(args) -> argparse.Namespace:
    """The run ``main`` makes: the model (``cfg``, ``params``, ``loss_fn``),
    the optimizer choice (it sets the default batch), the example batch and
    the ``AutoDist.function`` step under ``Parallax``, with the seconds its
    set-up took (the sparse walk and the strategy build)."""
    device = resolve_device(args.device)
    cfg, params, loss_fn = build_model(args, device)
    # The optimizer is the strategy layer's choice (Adam's state bytes against
    # the card's budget); the memory-tight choice gets the smaller batch.
    choice = choose_optimizer(params, learning_rate=1e-3)
    print(f"optimizer: {choice.reason}")
    if not args.batch_size:
        args.batch_size = 96 if choice.factored else 128
    if args.model == "lstm":
        example = lstm_lm.synthetic_batch(cfg, args.batch_size, args.seq_len,
                                          sampled=not args.full_softmax)
    else:
        example = transformer_lm.synthetic_batch(cfg, args.batch_size, args.seq_len)
    if args.data_dir and "neg_ids" in example:
        args.error("--data_dir feeds token shards; the sampled-softmax LSTM draws negatives "
                   "on the host per batch: use --full_softmax (or the transformer) with "
                   "--data_dir")
    t0 = time.perf_counter()
    ad = AutoDist(args.resource_spec, strategy_builder=Parallax(), device=device)
    step = ad.function(loss_fn, params, choice.optimizer, example_batch=example)
    setup_s = time.perf_counter() - t0
    print(f"set-up (sparse walk and strategy build): {setup_s:.1f} s")
    return argparse.Namespace(cfg=cfg, params=params, loss_fn=loss_fn, choice=choice,
                              example=example, step=step, setup_s=setup_s)


def main(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    """Prepare a corpus and exit, or train and return the average words/s."""
    args = parse_args(argv)
    if args.write_synthetic_corpus:
        write_synthetic_corpus(args)
        return None
    if args.tokenize_corpus:
        tokenize_corpus(args)
        return None

    run = build(args)
    step, loss_fn, example = run.step, run.loss_fn, run.example
    loader = feed = None
    if args.data_dir:
        loader, feed = open_feed(args, step)
        next_batch = lambda: next(feed)  # noqa: E731
    else:
        # Resident on the device: re-sending it every step would measure the
        # host link, not the card.
        resident = step.runner.shard_batch(example)
        next_batch = lambda: resident  # noqa: E731

    tokens_per_step = args.batch_size * args.seq_len
    meter = ThroughputMeter(batch_size=tokens_per_step, log_every=args.log_every)
    loss = None
    try:
        for i in range(args.steps):
            loss = step(next_batch())
            rate = meter.step(sync=loss)
            if rate is not None:
                print(f"step {i + 1}: {rate:.1f} words/sec")
    finally:
        if feed is not None:
            feed.close()     # stop the producer before its loader goes away
            loader.close()
    final = float(loss)
    avg = meter.finish() or 0.0
    print(f"final loss {final:.4f}; average {avg:.1f} words/sec")
    if not args.full_softmax:
        card_mfu(lambda: flops_util.loss_and_grad_flops(
            loss_fn, step.runner.logical_params(step.get_state()),
            step.runner.shard_batch(example)), avg / tokens_per_step, step.runner.device)
    return avg


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
