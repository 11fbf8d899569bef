"""The plan autotuner's check: the tuned plan's steps/s against the default
plan's, one JSON line (the port's counterpart of ``bench.py --autotune``,
``autotune_bench``, ``bench.py:1716-1800``; the same keys).

One full predict-prune-probe search (:func:`autodist_tpu_torch.strategy.autotune`)
with a throwaway plan cache, then the default plan (``PSLoadBalancing``,
per step) and the winner measured in turns through the tuner's probe loop
(best of ``--rounds``). ``tuned_vs_default`` should be at least 1, and
``probed`` at most ``top_k``. The model is ``bench.py``'s tiny one, whose
step is host-bound on the host and on the card alike (``chip_smoke.py``
phase 16 runs the search on NCF at 65,536). ``--baseline FILE`` compares with the ``autotune`` row of a JSON file of
H100 rows (``{"autotune": {"platform": "gpu", "min_ratio": 1.0}}``).

    python -m autodist_tpu_torch.examples.benchmark.autotune               # the card
    python -m autodist_tpu_torch.examples.benchmark.autotune --device cpu --rounds 1
"""

import argparse
import json
import sys
import tempfile
from typing import Optional, Sequence

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.strategy import PSLoadBalancing, autotune, measure_candidate
from autodist_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--steps", type=int, default=48,
                        help="optimizer steps a measurement (at least 4 dispatches)")
    parser.add_argument("--baseline", type=str, default="",
                        help="a JSON file of H100 rows with an autotune row")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    platform = "gpu" if device.type == "cuda" else "cpu"
    cfg = transformer_lm.TransformerLMConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64,
        dtype=torch.float32, tied_output=False)
    model, params = transformer_lm.init_params(cfg, seed=0, device=device)
    loss_fn = transformer_lm.make_loss_fn(model)
    batch = transformer_lm.synthetic_batch(cfg, batch_size=8, seq_len=16)

    def optimizer(p):
        return torch.optim.Adam(p, lr=1e-3)

    top_k = const.env_int(const.AUTODIST_TUNE_TOPK, const.TUNE_TOPK_DEFAULT)
    with tempfile.TemporaryDirectory() as tmp:
        plan = autotune(loss_fn, params, optimizer, batch, plan_cache=f"{tmp}/plan_cache.json",
                        warmup_steps=2, measure_steps=6, device=device)

    def measure(builder, unroll, zero, accum):
        r = measure_candidate(builder, loss_fn, params, optimizer, batch, warmup_steps=2,
                              measure_steps=max(4, args.steps // unroll), unroll=unroll,
                              zero=zero, accumulation_steps=accum, device=device)
        return r.steps_per_sec or 0.0

    best = {"default": 0.0, "tuned": 0.0}
    for _ in range(args.rounds):   # in turns: load noise hits both sides
        best["default"] = max(best["default"], measure(PSLoadBalancing(), 1, 0, 1))
        best["tuned"] = max(best["tuned"], measure(plan.make_builder(), plan.unroll,
                                                   plan.zero, plan.accumulation_steps))
    ratio = best["tuned"] / best["default"] if best["default"] else 0.0
    result = {
        "metric": f"autotune ({platform} x1, d{cfg.d_model}x{cfg.n_layers}, seq16, bs8)",
        "unit": "steps/s",
        "rows": {"default": round(best["default"], 2), "tuned": round(best["tuned"], 2)},
        "tuned_vs_default": round(ratio, 4),
        "plan": plan.name,
        "predicted_step_ms": round((plan.predicted or {}).get("step_s", 0.0) * 1e3, 4),
        "search_s": round(plan.search_s, 2),
        "enumerated": plan.enumerated,
        "probed": plan.probed,
        "top_k": top_k,
    }
    if plan.probed > top_k:
        print(f"WARNING: autotune measured {plan.probed} candidates, above top_k={top_k}",
              file=sys.stderr)
    if args.baseline:
        with open(args.baseline) as f:
            recorded = json.load(f).get("autotune")
        if recorded and recorded.get("platform") == platform:
            floor = recorded.get("min_ratio", 1.0)
            result["vs_min_ratio"] = round(ratio / floor, 4) if floor else None
            if ratio < floor:
                print(f"WARNING: the tuned plan runs at {ratio:.3f}x the default, under "
                      f"{floor} ({args.baseline})", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
