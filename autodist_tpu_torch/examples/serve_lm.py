"""Serve a Transformer LM with continuous batching: the runnable doc for
``autodist_tpu_torch/serving`` (the port of ``examples/serve_lm.py``).

    python -m autodist_tpu_torch.examples.serve_lm                  # tiny random LM, on the card
    python -m autodist_tpu_torch.examples.serve_lm --device cpu     # on the host
    python -m autodist_tpu_torch.examples.serve_lm --checkpoint /tmp/ckpt/model-100 \\
        --d_model 768 --n_layers 12                                 # trained params
    python -m autodist_tpu_torch.examples.serve_lm --mode static    # wave batching

Starts an :class:`~autodist_tpu_torch.serving.InferenceServer` in this
process, fires ``--clients`` concurrent client threads (each its own
connection, the intended concurrency model), and prints per-phase p50/p99
plus the server's ``serve.*`` SLO counters. With ``--mode static`` the same
offered load runs under wave batching — compare the p99s to see what
decode-step admission buys.
"""

import argparse
import sys
import threading
import time

import numpy as np
import torch

from autodist_tpu_torch import serving
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.testing.sanitizer import san_lock
from autodist_tpu_torch.utils.device import resolve_device


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint prefix to restore params from "
                             "(default: init a tiny random LM)")
    parser.add_argument("--d_model", type=int, default=64)
    parser.add_argument("--n_layers", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--max_len", type=int, default=128)
    parser.add_argument("--mode", choices=("continuous", "static"),
                        default="continuous")
    parser.add_argument("--max_batch", type=int, default=4)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=24,
                        help="total requests across all clients")
    parser.add_argument("--max_new", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for the host)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = transformer_lm.TransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=max(1, args.d_model // 32), n_layers=args.n_layers,
        d_ff=4 * args.d_model, max_len=args.max_len, dtype=torch.float32)
    model, params = transformer_lm.init_params(cfg, device=device)
    if args.checkpoint:
        from autodist_tpu_torch.checkpoint.saver import Saver
        restored = Saver().restore_params(args.checkpoint)
        missing = sorted(set(params) - set(restored))
        if missing:
            raise KeyError(f"checkpoint {args.checkpoint} lacks {missing[0]!r}")
        params = {k: restored[k].to(device=device, dtype=v.dtype) for k, v in params.items()}
        print(f"restored params from {args.checkpoint}")

    scfg = serving.ServeConfig.from_env(
        max_batch=args.max_batch, mode=args.mode,
        temperature=args.temperature)
    engine = serving.LMEngine(model, params, scfg)
    server = serving.InferenceServer(serving.Batcher(engine, scfg))
    print(f"serving {args.mode} mode, {args.max_batch} slots, buckets "
          f"{engine.buckets} on {server.address[0]}:{server.address[1]} ({device})")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, args.vocab, size=rng.randint(4, 48))
               .astype(np.int32) for _ in range(args.requests)]

    # Warm up off the clock: one prefill per bucket the workload will touch,
    # plus decode, so the printed p50/p99 measure serving, not first calls.
    warm = serving.ServeClient(server.address)
    try:
        for b in sorted({serving.bucket_for(len(p), engine.buckets)
                         for p in prompts}):
            if b + 2 <= args.max_len:   # a fuller bucket can't serve anyway
                warm.generate(np.arange(1, 1 + b, dtype=np.int32), 2)
    finally:
        warm.close()
    timings, errors = [], []
    lock = san_lock()

    def client_thread(worker_id):
        c = serving.ServeClient(server.address)
        try:
            for i in range(worker_id, args.requests, args.clients):
                try:
                    _, timing = c.generate(prompts[i], args.max_new,
                                           seed=i)
                    with lock:
                        timings.append(timing)
                except serving.ServeError as e:
                    with lock:
                        errors.append(str(e))
        finally:
            c.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client_thread, args=(w,))
               for w in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    print(f"\n{len(timings)}/{args.requests} requests ok, "
          f"{len(errors)} rejected, {len(timings) / wall:.1f} req/s "
          f"({args.clients} clients, wall {wall:.2f}s)")
    print(f"{'phase':>8}  {'p50 ms':>9}  {'p99 ms':>9}")
    for phase in ("queue", "prefill", "decode", "total"):
        xs = [t[f"{phase}_s"] * 1e3 for t in timings]
        print(f"{phase:>8}  {percentile(xs, 50):9.2f}  "
              f"{percentile(xs, 99):9.2f}")

    stats = server.stats_snapshot()
    reg = stats["registry"]
    print(f"\nserver: {reg.get('serve.requests.completed', 0)} completed, "
          f"{reg.get('serve.requests.rejected', 0)} rejected, "
          f"final batch_fill {reg.get('serve.batch_fill', 0.0):.2f}, "
          f"wire {stats['wire']['bytes_received']} B in / "
          f"{stats['wire']['bytes_sent']} B out")
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
