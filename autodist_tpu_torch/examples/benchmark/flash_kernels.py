"""The flash kernels' times on one card, for whichever
``autodist_tpu_torch`` is importable: run it as a file with ``PYTHONPATH``
naming a checkout, so one call can hold two versions of the kernels against
each other, in turns (as ``step_kernels.py`` does for a step). It uses the
wrappers every version since the flash kernels' port has (``flash_fwd``,
``flash_fwd_carry``, ``flash_bwd_dkdv``, ``flash_bwd_dq`` and
``prepare_backward_q_side``), each as the long-context step calls it: B = 8,
L = 8,192, 8 heads, causal, bf16, no carry in, bf16 gradients. The
``backward`` row is the whole backward as ``_FlashAttention.backward`` runs
it: ``flash_bwd`` where the checkout has it, else the dK/dV and dQ pair;
``backward_with_d`` adds D's pass (``prepare_backward_q_side``), as the
library's backward computes its own. At ``--hd 128`` the pair's own rows
are left out where its wrappers have no hd-128 kernel. One JSON line: each
row's CUDA-event ms (the median of ``--rounds`` rounds of ``--reps``
calls), the launches each wrapper counted, and the card's name and power
limit.

    PYTHONPATH=. python3 autodist_tpu_torch/examples/benchmark/flash_kernels.py this --hd 128
    PYTHONPATH=build/parent python3 autodist_tpu_torch/examples/benchmark/flash_kernels.py \
        parent --hd 128
"""

import argparse
import json
import statistics
import subprocess

import torch

import autodist_tpu_torch
from autodist_tpu_torch.ops import flash_attention as fa


def time_ms(fn, reps: int) -> float:
    """CUDA-event ms a call of ``fn`` over ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("label", help="the name of this checkout in the JSON line")
    parser.add_argument("--hd", type=int, default=64, help="head width")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    b, length, heads = 8, 8192, 8

    def draw(std=1.0):
        return (torch.randn(b, length, heads, args.hd, generator=gen) * std).to(
            dev, torch.bfloat16)

    q, k, v, do = draw(), draw(), draw(), draw(0.1)
    out, lse = fa.flash_fwd(q, k, v)
    dd = fa.prepare_backward_q_side(out, do)
    one_pass = getattr(fa, "flash_bwd", None)
    pair = args.hd == 64 or hasattr(fa.flash_bwd_dkdv, "hd128")

    def backward(d):
        if one_pass is not None:
            return one_pass(q, k, v, do, lse, d)
        return fa.flash_bwd_dkdv(q, k, v, do, lse, d), fa.flash_bwd_dq(q, k, v, do, lse, d)

    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v),
             "flash_fwd_carry": lambda: fa.flash_fwd_carry(q, k, v)}
    if pair:
        calls.update(flash_bwd_dkdv=lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, dd),
                     flash_bwd_dq=lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd))
    calls.update(backward=lambda: backward(dd),
                 backward_with_d=lambda: backward(fa.prepare_backward_q_side(out, do)))
    rounds = {name: [] for name in calls}
    for _ in range(args.rounds):               # kernels in turns within the run too
        for name, fn in calls.items():
            rounds[name].append(time_ms(fn, args.reps))
    counts = fa.KERNELS + getattr(fa, "KERNELS_HD128", ()) + tuple(
        w for w in (fa.prepare_backward_q_side,) if hasattr(w, "launches"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"label": args.label, "package": autodist_tpu_torch.__file__, "hd": args.hd,
              "shape": [b, length, heads, args.hd], "card": card,
              "ms": {name: statistics.median(r) for name, r in rounds.items()},
              "rounds": rounds, "backward": "flash_bwd" if one_pass else "pair",
              "launches": {c.__name__: c.launches for c in counts if c.launches}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
