"""Disk-fed against device-resident flagship throughput (the port's
counterpart of ``examples/benchmark/disk_input.py``).

The flagship TransformerLM (d512 x 6, 8 heads, d_ff 2048, vocab 32,000,
untied fused head, bf16 activations, f32 params; ``AllReduce``, Adam 1e-3,
384 sequences of 256 tokens a card, no accumulation) trained twice: (a) from
one batch kept on the card, and (b) from a token corpus in ``.npy`` shards
(``save_shards``), memory-mapped and gathered by the native ``DataLoader``
and copied to the card ahead of the step by ``device_prefetch``. A healthy
input pipeline keeps (b) within a few percent of (a). Each run takes 3
warm-up steps and ``--steps`` timed ones, the last loss read back as the
fence. One JSON line: ``resident_tokens_per_sec``, ``disk_tokens_per_sec``,
``disk_vs_resident``, ``corpus_rows``, ``shards``, ``native_loader``.

    python -m autodist_tpu_torch.examples.benchmark.disk_input [--rows 100000] [--steps 30]
    # tiny, on the host (d64 x 2, 8 x 32 tokens, the fused head's plain version):
    python -m autodist_tpu_torch.examples.benchmark.disk_input --device cpu --rows 64 --steps 2
"""

import argparse
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AutoDist, const
from autodist_tpu_torch.data import DataLoader, device_prefetch, save_shards
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils.device import resolve_device

WARMUP_STEPS = 3


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=100_000,
                        help="corpus rows (each seq_len+1 int32 tokens)")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="global batch; 0 = 384 a card (8 on the host)")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="reuse an existing corpus of tokens-*.npy shards (else a "
                             "synthetic one is written to a temporary directory)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Both runs; prints and returns the JSON line's dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = transformer_lm.TransformerLMConfig(
        vocab_size=32_000, d_model=512 if on_card else 64, n_heads=8,
        n_layers=6 if on_card else 2, d_ff=2048 if on_card else 256, max_len=512,
        dtype=torch.bfloat16 if on_card else torch.float32, tied_output=False,
        fused_head=True)
    seq_len = 256 if on_card else 32
    n_dev = const.ENV.WORLD_SIZE.val or 1
    batch_size = args.batch_size or (384 if on_card else 8) * n_dev

    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    example = transformer_lm.synthetic_batch(cfg, batch_size, seq_len)
    step = AutoDist(strategy_builder=AllReduce(), device=device).function(
        transformer_lm.make_loss_fn(model), params,
        lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8), example_batch=example)

    def timed(get_batch, label):
        for _ in range(WARMUP_STEPS):
            loss = step(get_batch())
        float(loss)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(get_batch())
        float(loss)                 # the read-back is the completion fence
        rate = batch_size * seq_len * args.steps / (time.perf_counter() - t0)
        print(f"{label}: {rate:,.0f} tokens/s")
        return rate

    # (a) one batch kept on the card: the card-only ceiling.
    resident = step.runner.shard_batch(example)
    rate_resident = timed(lambda: resident, "device-resident synthetic")

    # (b) memory-mapped shards -> native gather -> device_prefetch.
    data_dir, tmp = args.data_dir, None
    if data_dir is None:
        tmp = tempfile.mkdtemp(prefix="autodist_corpus_")
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, cfg.vocab_size, size=(args.rows, seq_len + 1)).astype(np.int32)
        save_shards({"tokens": tokens}, tmp, rows_per_shard=max(1, args.rows // 8))
        del tokens
        data_dir = tmp
    try:
        shards = sorted(glob.glob(os.path.join(glob.escape(data_dir), "tokens-*.npy")))
        loader = DataLoader(files={"tokens": shards}, batch_size=batch_size, shuffle=True,
                            prefetch=4)
        feed = device_prefetch(loader, step.runner, depth=2)
        try:
            rate_disk = timed(lambda: next(feed), "disk-fed (mmap shards)")
            native = loader.is_native
        finally:
            feed.close()     # stop the producer before its loader goes away
            loader.close()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    result = {"resident_tokens_per_sec": round(rate_resident),
              "disk_tokens_per_sec": round(rate_disk),
              "disk_vs_resident": round(rate_disk / rate_resident, 4),
              "corpus_rows": loader.n_rows,
              "shards": len(shards), "native_loader": native}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
