"""The fused multi-step path's sweep: steps/s of ``runner.run_many`` at each
unroll factor, one JSON line (the port's counterpart of ``bench.py
--unroll``, ``unroll_sweep``, ``bench.py:1619-1713``; the same keys).

On the card it trains the flagship at its real shape with accumulation off
(d512 x 6, vocab 32,000, untied fused head, bf16, 384 x 256 a card), so the
sweep isolates what a K-step CUDA graph saves over K dispatches; on the host
a tiny model whose step is host-bound. Under ``torchrun`` every process is a
data rank (NCCL on the cards, gloo on the host) and the global batch is 384
(8 on the host) a rank. ``speedup_vs_unroll1`` is the largest factor's rate
over unroll 1's. Before timing, a second session holds the first factor
above 1 against that many ``run()`` steps from the same weights:
``bit_identical`` says whether the losses and parameters agree bit for bit
(on every rank). ``--baseline FILE`` compares it with the
``unroll_curve`` row of a JSON file of H100 rows (``{"unroll_curve":
{"platform": "gpu", "speedup_vs_unroll1": x, "threshold_pct": 5}}``);
``PERF_BASELINE.json`` holds TPU and CPU rows and is not read.
``--optimizer adafactor`` trains under the port's ``Adafactor`` (what
``choose_optimizer`` hands out when Adam's moments do not fit) and
``--zero 1`` cuts every update over the data ranks (``zero=``), where
Adafactor all-reduces its whole-tensor statistics inside the captured step.
The sweep ends in ``runner.shutdown`` (the graphs released, then the group
destroyed; it prints the seconds that took to stderr). ``SIGUSR1`` prints
every thread's Python stack to stderr, so a rank that hangs can be read:
``pkill -USR1 -f benchmark.unroll``.

    python -m autodist_tpu_torch.examples.benchmark.unroll               # the card
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m autodist_tpu_torch.examples.benchmark.unroll                   # 4 cards
    python -m autodist_tpu_torch.examples.benchmark.unroll --device cpu --factors 1,4
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m autodist_tpu_torch.examples.benchmark.unroll --optimizer adafactor --zero 1
"""

import argparse
import faulthandler
import json
import signal
import sys
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from autodist_tpu_torch import AllReduce, AutoDist, optimizers
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--factors", default="1,2,4,8",
                        help="comma-separated unroll factors")
    parser.add_argument("--steps", type=int, default=0,
                        help="steps timed at each factor (0: 160 on the card, 192 on the "
                             "host, as bench.py)")
    parser.add_argument("--baseline", type=str, default="",
                        help="a JSON file of H100 rows with an unroll_curve row")
    parser.add_argument("--optimizer", choices=("adam", "adafactor"), default="adam",
                        help="Adam 1e-3, or the port's Adafactor 1e-3 (optax.adafactor)")
    parser.add_argument("--zero", type=int, default=0,
                        help="the session's zero= (1: each update cut over the data ranks)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    factors = [int(f) for f in args.factors.split(",")]
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        cfg = transformer_lm.TransformerLMConfig(
            vocab_size=32_000, d_model=512, n_heads=8, n_layers=6, d_ff=2048, max_len=512,
            dtype=torch.bfloat16, tied_output=False, fused_head=True)
        batch_size, seq_len, total_steps = 384, 256, 160
    else:
        cfg = transformer_lm.TransformerLMConfig(
            vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
            dtype=torch.float32, tied_output=False)
        batch_size, seq_len, total_steps = 8, 16, 192
    total_steps = args.steps or total_steps
    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    loss_fn = transformer_lm.make_loss_fn(model)

    def optimizer(p):
        if args.optimizer == "adafactor":
            return optimizers.Adafactor(p, lr=1e-3)
        return torch.optim.Adam(p, lr=1e-3, eps=1e-8)

    def session():
        ad = AutoDist(strategy_builder=AllReduce(), device=device)
        runner = ad.create_distributed_session(
            loss_fn, params, optimizer,
            example_batch=transformer_lm.synthetic_batch(cfg, batch_size, seq_len),
            zero=args.zero)
        return runner, runner.init(params)

    runner, state = session()
    n_dev = runner.plan.dp_size
    batches = [transformer_lm.synthetic_batch(cfg, batch_size * n_dev, seq_len, seed=i)
               for i in range(1 + max(factors))]
    batch = runner.shard_batch(batches[0])
    float(runner.run(state, batch)[1])        # the card's warm-up: lazy state, handles

    # run_many against run() from the same state: on a second session, the
    # same first step, then run() where this one runs one block.
    k = next((f for f in factors if f > 1), 1)
    check, check_state = session()
    float(check.run(check_state, batch)[1])
    want = torch.stack([check.run(check_state, b)[1] for b in batches[1:k + 1]])
    got = runner.run_many(state, batches[1:k + 1])[1]
    same = torch.equal(got, want) and all(
        torch.equal(state.params[key], check_state.params[key]) for key in state.params)
    del check, check_state
    same_everywhere = torch.tensor([int(same)], device=device)
    if dist.is_initialized():
        dist.all_reduce(same_everywhere, op=dist.ReduceOp.MIN)
    rows = {}
    for k in factors:
        block = runner.shard_block([batch] * k)
        _, losses = runner.run_many(state, block)   # capture, then the first replay
        float(losses[-1])
        n_blocks = max(3, total_steps // k)
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            _, losses = runner.run_many(state, block)
        float(losses[-1])                            # the fence: the last block's loss
        rows[str(k)] = round(n_blocks * k / (time.perf_counter() - t0), 2)

    platform = "gpu" if on_card else "cpu"
    result = {
        "metric": f"unroll_sweep ({platform} x{n_dev}, d{cfg.d_model}x{cfg.n_layers}, "
                  f"seq{seq_len}, bs{batch_size * n_dev}"
                  + (f", {args.optimizer}" if args.optimizer != "adam" else "")
                  + (f", zero={args.zero}" if args.zero else "") + ")",
        "unit": "steps/s",
        "rows": rows,
        "tokens_per_step": batch_size * n_dev * seq_len,
        "bit_identical": bool(same_everywhere.item()),
    }
    if "1" in rows:
        max_f = max(int(f) for f in rows)
        result["best_factor"] = max((int(f) for f in rows), key=lambda f: rows[str(f)])
        result["speedup_vs_unroll1"] = round(rows[str(max_f)] / rows["1"], 4)
        if args.baseline:
            with open(args.baseline) as f:
                recorded = json.load(f).get("unroll_curve")
            if recorded and recorded.get("platform") == platform:
                rec = recorded["speedup_vs_unroll1"]
                threshold = recorded.get("threshold_pct", 5.0)
                result["vs_recorded_speedup"] = round(result["speedup_vs_unroll1"] / rec, 4)
                if result["speedup_vs_unroll1"] < rec * (1.0 - threshold / 100.0):
                    print(f"WARNING: unroll speedup {result['speedup_vs_unroll1']:.2f}x is "
                          f"more than {threshold}% below the recorded {rec:.2f}x "
                          f"({args.baseline})", file=sys.stderr)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(result))
    if dist.is_initialized():
        t0 = time.perf_counter()
        shutdown()
        print(f"unroll: graphs released and process group destroyed in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return result


if __name__ == "__main__":
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    main()
