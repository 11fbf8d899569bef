"""The fused head's kernel times on one card, for whichever
``autodist_tpu_torch`` is importable: run it as a file with ``PYTHONPATH``
naming a checkout, so one call can hold two versions of the kernels against
each other, in turns (as ``flash_kernels.py`` does for flash). It uses the
wrappers every version since the wide kernels' port has (``xent_pack_w``,
``xent_fwd``, ``xent_dh``, ``xent_dwdb``): the forward with its pack, dh and
dW/db on a table packed beforehand, as the backward runs them. Shapes
(``--shapes``): ``d512`` (D = 512, N = 98,304, the flagship's micro-batch),
``d768`` (scale_lm's default head: N = 49,152), ``d1024`` (scale_lm's d1024
head: N = 32,768), all at V = 32,000, "dv", no bias, bf16 h; and ``lm1b``
(D = 1,024, N = 32,768, V = 793,471, "vd", a bias, f32 h rounded by the
wrappers); ``d1024_vd`` and ``lm1b_dv`` are those two with the other
layout. One JSON line: each row's CUDA-event ms (the median of
``--rounds`` rounds, the rows in turns within each round), its bound (the
larger of bytes over 3.35 TB/s and operations over 989 TFLOP/s) and share
of it, the launches each wrapper counted, and the card's name and power
limit.

    PYTHONPATH=. python3 autodist_tpu_torch/examples/benchmark/xent_kernels.py this
    PYTHONPATH=build/parent python3 autodist_tpu_torch/examples/benchmark/xent_kernels.py parent

``--variants FILE`` times text variants of this checkout's
``ops/csrc/fused_xent.cu`` instead (``kernel_variants.py``: ``{"name":
[[old, new], ...]}``), in turns within each round. Each variant's dh, dw
and db are held against the first variant's on the first round (the
largest difference), and its ptxas lines for the wide kernels (registers,
spills, serialization warnings) are kept.

``--trace`` instead builds this checkout's source with the wide walks'
``XENT_WALK_STAMP`` markers defined (:data:`TRACE_HEADER`: ``clock64()`` at
each of :data:`TRACE_STEPS`, block 40, thread 0 of each consumer, tiles or
stripes 100-163), runs each kernel once at each shape after a warm-up call,
and prints the median SM cycles of each step and of a whole tile, for the
kernels that walk it (dh at D = 1,024 with the "dv" table runs the D = 512
order, which has no stamps).
"""

import argparse
import ctypes
import json
import pathlib
import statistics

import torch

import autodist_tpu_torch
from autodist_tpu_torch.ops import fused_xent as fx

try:
    from autodist_tpu_torch.examples.benchmark import kernel_variants as kv
except ImportError:   # an older checkout on PYTHONPATH: the helper beside this file
    import kernel_variants as kv

PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# name: (D, N, V, layout, bias, h dtype)
SHAPES = {"d512": (512, 98304, 32000, "dv", False, torch.bfloat16),
          "d768": (768, 49152, 32000, "dv", False, torch.bfloat16),
          "d1024": (1024, 32768, 32000, "dv", False, torch.bfloat16),
          "d1024_vd": (1024, 32768, 32000, "vd", False, torch.bfloat16),
          "lm1b": (1024, 32768, 793471, "vd", True, torch.float32),
          "lm1b_dv": (1024, 32768, 793471, "dv", True, torch.float32)}


# The wide walks' steps that --trace times, in the order of the stamps that
# end them (stamp k + 1 ends step k; stamp 0 is the top of a tile).
TRACE_STEPS = ("scores of the next tile issued (a ring of three)",
               "the exchange within the block and the send to the partner",
               "the wait for the last tile's second product",
               "the partner's sum and the exponentials",
               "named barrier 4 (the P tile free)",
               "P stored and published",
               "scores of the next tile issued (a ring of two: waits on its load)",
               "the second product issued",
               "the next tile's scores landed")


# Included before the source in the --trace build: the stamps and their reader.
TRACE_HEADER = """#include <cuda_runtime.h>
__device__ long long xent_trace[2][2][64][10];
#define XENT_WALK_STAMP(kernel, k) do { if (blockIdx.x == 40 && tid == 0 && t >= 100 && \\
    t < 164) xent_trace[kernel][c][t - 100][k] = clock64(); } while (0)
extern "C" int xent_trace_read(void* host) {
  return int(cudaMemcpyFromSymbol(host, xent_trace, sizeof(xent_trace)));
}
extern "C" int xent_trace_clear() {
  static const long long zeros[2][2][64][10] = {};
  return int(cudaMemcpyToSymbol(xent_trace, zeros, sizeof(xent_trace)));
}
"""


def run_trace(shapes, dev) -> dict:
    """:data:`TRACE_STEPS`' median cycles at each shape, by kernel and consumer."""
    import numpy as np
    header = kv.OUT / "xent_trace.h"
    header.parent.mkdir(parents=True, exist_ok=True)
    header.write_text(TRACE_HEADER)
    lib_path, _ = kv.build("fused_xent", {"trace": []}, lambda line: False,
                           ("-include", str(header)))["trace"]
    lib = kv.load(lib_path, fx._lib)
    lib.xent_trace_read.argtypes = [ctypes.c_void_p]
    real_lib = fx._lib
    fx._lib = lambda: lib
    out = {}
    try:
        for shape in shapes:
            h, w, b, g, lse, wp, layout = inputs(shape, dev)
            if lib.xent_trace_clear() != 0:   # a kernel with no stamps leaves zeros
                raise RuntimeError("xent_trace_clear failed")
            for _ in range(2):
                fx.xent_dh(h, w, b, lse, g, layout, wp=wp)
                fx.xent_dwdb(h, w, b, lse, g, layout, wp=wp)
            torch.cuda.synchronize()
            stamps = np.zeros((2, 2, 64, 10), np.int64)
            if lib.xent_trace_read(stamps.ctypes.data) != 0:
                raise RuntimeError("xent_trace_read failed")
            out[shape] = {}
            for kind, name in enumerate(("xent_dh", "xent_dwdb")):
                for c in range(2):
                    if not stamps[kind, c].any():     # a kernel with no stamps ran
                        continue
                    steps = np.diff(stamps[kind, c], axis=1)
                    out[shape][f"{name} consumer {c}"] = {
                        "tile": float(np.median(np.diff(stamps[kind, c, :, 0]))),
                        **{step: float(np.median(steps[:, k]))
                           for k, step in enumerate(TRACE_STEPS)}}
            del h, w, b, g, lse, wp
            torch.cuda.empty_cache()
    finally:
        fx._lib = real_lib
    return out


def bound_ms(name: str, d: int, n: int, v: int, bias: bool, h_bytes: int) -> float:
    """The least time for the row's work: each input read once and each
    output written once (h, the f32 table (the forward) or the packed one,
    lse, g, dh, dw, db), against 2 N D V tensor-core operations a product
    (one for the forward, two for each backward kernel)."""
    h, b, vec = n * d * h_bytes, v * 4 if bias else 0, n * 4
    nbytes, products = {"xent_fwd": (h + d * v * 4 + b + vec, 1),
                        "xent_dh": (2 * h + d * v * 2 + b + 2 * vec, 2),
                        "xent_dwdb": (h + d * v * 2 + b + 2 * vec + d * v * 4 + v * 4, 2)}[name]
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, products * 2.0 * n * d * v / PEAK_BF16_FLOPS)


def inputs(shape: str, dev):
    d, n, v, layout, bias, h_dtype = SHAPES[shape]
    gen = torch.Generator(dev).manual_seed(0)   # on the card: lm1b's table is 3.2 GB
    h = (torch.randn(n, d, generator=gen, device=dev) * 0.5).to(h_dtype)
    w = torch.randn(d, v, generator=gen, device=dev) * 0.05
    w = w.T.contiguous() if layout == "vd" else w
    b = torch.randn(v, generator=gen, device=dev) * 0.1 if bias else None
    g = torch.full((n,), 1.0 / n, device=dev)
    lse = fx.xent_fwd(h, w, b, layout)
    return h, w, b, g, lse, fx.xent_pack_w(w, layout), layout


def calls(shape: str, args):
    """The row's three calls on ``args`` (from :func:`inputs`)."""
    h, w, b, g, lse, wp, layout = args
    return {f"xent_fwd {shape}": lambda: fx.xent_fwd(h, w, b, layout),
            f"xent_dh {shape}": lambda: fx.xent_dh(h, w, b, lse, g, layout, wp=wp),
            f"xent_dwdb {shape}": lambda: fx.xent_dwdb(h, w, b, lse, g, layout, wp=wp)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("label", help="the name of this checkout in the JSON line")
    parser.add_argument("--shapes", default="d512,d768,d1024,lm1b",
                        help=f"comma-separated, of {sorted(SHAPES)}")
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=3,
                        help="calls a timing (one at lm1b's shape)")
    parser.add_argument("--variants", help="JSON file of {name: [[old, new], ...]}")
    parser.add_argument("--trace", action="store_true",
                        help="cycles of each step of the wide walks (see above)")
    args = parser.parse_args(argv)
    dev = torch.device("cuda:0")
    shapes = args.shapes.split(",")
    if args.trace:
        result = {"label": args.label, "card": kv.card(), "trace": run_trace(shapes, dev)}
        print(json.dumps(result))
        return result
    libs = {args.label: None}
    ptxas = {}
    if args.variants:
        built = kv.build("fused_xent", json.loads(pathlib.Path(args.variants).read_text()),
                         lambda line: "_wide" in line and ("xent_dh" in line or "xent_dwdb" in line))
        libs = {name: kv.load(path, fx._lib) for name, (path, _) in built.items()}
        ptxas = {name: lines for name, (_, lines) in built.items()}
    real_lib = fx._lib
    rounds, diffs = {}, {}
    try:
        for shape in shapes:
            data = inputs(shape, dev)
            reps = 1 if shape == "lm1b" else args.reps
            first = None
            for r in range(args.rounds):      # the variants (or the one checkout) in turns
                for name, lib in libs.items():
                    if lib is not None:
                        fx._lib = lambda lib=lib: lib
                    for row, fn in calls(shape, data).items():
                        rounds.setdefault(name, {}).setdefault(row, []).append(kv.time_ms(fn, reps))
                    if r == 0 and args.variants:
                        h, w, b, g, lse, wp, layout = data
                        got = (fx.xent_dh(h, w, b, lse, g, layout, wp=wp),
                               *fx.xent_dwdb(h, w, b, lse, g, layout, wp=wp))
                        first = got if first is None else first
                        diffs.setdefault(name, {})[shape] = [
                            (x.float() - y.float()).abs().max().item() for x, y in zip(got, first)]
                    fx._lib = real_lib
            del data
            torch.cuda.empty_cache()
    finally:
        fx._lib = real_lib
    card = kv.card()
    bounds = {}
    for shape in shapes:
        d, n, v, _, bias, h_dtype = SHAPES[shape]
        h_bytes = 2 if h_dtype == torch.bfloat16 else 4
        for name in ("xent_fwd", "xent_dh", "xent_dwdb"):
            bounds[f"{name} {shape}"] = bound_ms(name, d, n, v, bias, h_bytes)
    ms = {name: {row: statistics.median(t) for row, t in rows.items()}
          for name, rows in rounds.items()}
    result = {"label": args.label, "package": autodist_tpu_torch.__file__, "card": card,
              "ms": ms, "bound_ms": bounds,
              "bound_share": {name: {row: bounds[row] / t for row, t in rows.items()}
                              for name, rows in ms.items()},
              "rounds": rounds,
              "launches": {k.__name__: k.launches for k in (*fx.KERNELS, fx.xent_pack_w)}}
    if args.variants:
        result.update(max_diff_vs_first=diffs, ptxas=ptxas)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
