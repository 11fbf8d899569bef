"""Variants of the flash kernels' source timed in turns on one card: each
variant is ``ops/csrc/flash_attention.cu`` with text replacements applied,
built with the port's flags into its own library under ``build/variants/``
and swapped in for the wrappers' library, so one process holds them against
each other at the long-context shape (B = 8, L = 8,192, 8 heads, causal,
bf16). The variants come from a JSON file: ``{"name": [[old, new], ...]}``,
each ``old`` found exactly once (an empty list is the source as it is).
Each variant's ``flash_bwd`` is timed over ``--rounds`` rounds of
``--reps`` calls, the variants in turns within each round; its dq, dk and dv
are held against the plain version (the largest error over each output's
largest magnitude). One JSON line: each variant's times, errors and ptxas
lines (serialization warnings; the one-pass kernel's stack and spills),
and the card's name and power limit.

    python3 autodist_tpu_torch/examples/benchmark/flash_variants.py variants.json --hd 128
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import torch

from autodist_tpu_torch.ops import _build
from autodist_tpu_torch.ops import flash_attention as fa

SOURCE = _build.SOURCES["flash_attention"]
OUT = _build.BUILD_DIR / "variants"


def time_ms(fn, reps: int) -> float:
    """CUDA-event ms a call of ``fn`` over ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build(variants):
    """Each variant's library, built in parallel: ``{name: (path, ptxas lines)}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in the source once")
            src = src.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent), "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log[-3000:]}")
        lines = log.splitlines()
        # Serialization warnings, and the one-pass kernel's stack and spills.
        built[name] = (OUT / f"lib{name}.so",
                       [line.strip() for line in lines if "serialized" in line]
                       + [lines[i + 1].strip() for i, line in enumerate(lines[:-1])
                          if "Function properties for" in line and "flash_bwd_kernel" in line])
    return built


def load(path: pathlib.Path):
    """The variant's library with the wrappers' argument types."""
    real = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))
    try:
        return fa._lib.__wrapped__()
    finally:
        _build.load = real


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", help="JSON file of {name: [[old, new], ...]}")
    parser.add_argument("--hd", type=int, default=128)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    built = build(json.loads(pathlib.Path(args.variants).read_text()))
    libs = {name: load(path) for name, (path, _) in built.items()}
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
                rounds[name].append(time_ms(call, args.reps))
                if name not in errors:
                    got = call()
                    errors[name] = [((g.float() - w.float()).abs().max()
                                     / w.float().abs().max()).item() for g, w in zip(got, want)]
    finally:
        fa._lib = real_lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"shape": list(shape), "card": card,
              "ms": {name: statistics.median(r) for name, r in rounds.items()},
              "rounds": rounds, "errors": errors,
              "ptxas": {name: lines for name, (_, lines) in built.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
