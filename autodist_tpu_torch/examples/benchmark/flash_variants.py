"""Variants of the flash kernels' source timed in turns on one card: each
variant is ``ops/csrc/flash_attention.cu`` with text replacements applied,
built into its own library (``kernel_variants.py``), so one process holds
them against each other at the long-context shape (B = 8, L = 8,192, 8
heads, causal, bf16). The variants come from a JSON file: ``{"name": [[old,
new], ...]}``, each ``old`` found exactly once (an empty list is the source
as it is). Each variant's ``flash_bwd`` is timed over ``--rounds`` rounds
of ``--reps`` calls, the variants in turns within each round; its dq, dk
and dv are held against the plain version (the largest error over each
output's largest magnitude). One JSON line: each variant's times, errors
and ptxas lines (serialization warnings; the one-pass kernel's registers,
stack and spills), and the card's name and power limit.

    python3 autodist_tpu_torch/examples/benchmark/flash_variants.py variants.json --hd 128
"""

import argparse
import json
import pathlib
import statistics
import sys

import torch

from autodist_tpu_torch.examples.benchmark import kernel_variants as kv
from autodist_tpu_torch.ops import flash_attention as fa


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", help="JSON file of {name: [[old, new], ...]}")
    parser.add_argument("--hd", type=int, default=128)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    built = kv.build("flash_attention", json.loads(pathlib.Path(args.variants).read_text()),
                     lambda line: "flash_bwd_kernel" in line)
    libs = {name: kv.load(path, fa._lib) for name, (path, _) in built.items()}
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    shape = (8, 8192, 8, args.hd)
    q, k, v = ((torch.randn(*shape, generator=gen)).to(dev, torch.bfloat16) for _ in range(3))
    do = (torch.randn(*shape, generator=gen) * 0.1).to(dev, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v)
    dd = fa.prepare_backward_q_side(out, do)
    want = fa.flash_backward_plain(q, k, v, do, lse, dd)

    def call():
        return fa.flash_bwd(q, k, v, do, lse, dd)

    real_lib = fa._lib
    rounds = {name: [] for name in libs}
    errors = {}
    try:
        for _ in range(args.rounds):
            for name, lib in libs.items():
                fa._lib = lambda lib=lib: lib
                rounds[name].append(kv.time_ms(call, args.reps))
                if name not in errors:
                    got = call()
                    errors[name] = [((g.float() - w.float()).abs().max()
                                     / w.float().abs().max()).item() for g, w in zip(got, want)]
    finally:
        fa._lib = real_lib
    result = {"shape": list(shape), "card": kv.card(),
              "ms": {name: statistics.median(r) for name, r in rounds.items()},
              "rounds": rounds, "errors": errors,
              "ptxas": {name: lines for name, (_, lines) in built.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
