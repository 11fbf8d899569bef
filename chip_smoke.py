#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build its CUDA kernels, hold each against
its plain version on the card, and train the flagship TransformerLM through
the port's entry points on one card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and ``nvcc``;
exits non-zero without them, or when any phase fails. Phases:

1. The card's name and power limit (``nvidia-smi``), TF32 off.
2. Build every kernel source of the port into ``build/`` (timed).
3. Each fused-LM-head kernel against its plain version on the same inputs:
   D = 512 with bf16 activations and an f32 table, both table layouts, with
   and without a bias, ragged N and V (1,000 x 31,999), and the main path's
   own shape (8,192 x 32,000, "dv", no bias). Tolerance, for bf16 operands
   and another summation order (the JAX tests loosen by the same amounts):
   lse within 0.01 absolute; dh, dw and db within 0.05 of the largest
   reference entry. Then each kernel is timed at the flagship micro-batch
   (N = 98,304) beside its plain version, the one PyTorch call computing
   the same function where there is one, and its bound.
4. The flagship at full width (d512 x 6 layers, 8 heads, d_ff 2048, vocab
   32,000, seq 256, untied fused head, bf16 activations, f32 params) through
   ``AutoDist(resource_info=..., strategy_builder=AllReduce()).function``
   with Adam(1e-3) and 2-way gradient accumulation over micro-batches of 32
   sequences, for 3 steps; launch counts are set to 0 just before and read
   just after. First, on a small batch, its fused-head loss is held against
   the plain logits head with the same weights (rtol 1e-2: bf16 logits).
   Then tokens/s and MFU over 6 more steps, and a ``torch.profiler``
   window over 3 more: the device's busy time per step, its idle share of
   the wall time, and the top kernels.
5. One JSON line of per-kernel numbers, then the result line.
"""

import collections
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

D, V = 512, 32000
MAIN_MICRO_ROWS = 32 * 256        # rows the main path's head sees per micro-batch
FLAGSHIP_ROWS = 384 * 256         # the JAX flagship's micro-batch (bench.py)
LSE_ATOL = 0.01
GRAD_RTOL_OF_MAX = 0.05
STEADY_STEPS = 6                  # steps timed for throughput after the counted run
PROFILE_STEPS = 3                 # steps traced after those


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def inputs(n, v, layout, bias, gen, dev):
    h = (torch.randn(n, D, generator=gen) * 0.5).to(dev, torch.bfloat16)
    w = torch.randn(D, v, generator=gen) * 0.05
    w = (w.T.contiguous() if layout == "vd" else w).to(dev)
    b = (torch.randn(v, generator=gen) * 0.1).to(dev) if bias else None
    g = torch.rand(n, generator=gen).to(dev)
    return h, w, b, g


def check_kernels(fx, dev):
    """Phase 3a: every kernel against its plain version; max abs errors."""
    gen = torch.Generator().manual_seed(0)
    errs = {"xent_fwd": 0.0, "xent_dh": 0.0, "xent_dwdb": 0.0}
    cases = [(1000, V - 1, layout, bias) for layout in ("dv", "vd") for bias in (True, False)]
    cases.append((MAIN_MICRO_ROWS, V, "dv", False))
    for n, v, layout, bias in cases:
        h, w, b, g = inputs(n, v, layout, bias, gen, dev)
        lse = fx.xent_fwd(h, w, b, layout)
        dh = fx.xent_dh(h, w, b, lse, g, layout)
        dw, db = fx.xent_dwdb(h, w, b, lse, g, layout)
        torch.cuda.synchronize()
        ref_lse = fx.matmul_logsumexp_plain(h, w, b, layout)
        ref_dh, ref_dw, ref_db = fx.lse_backward_plain(h, w, b, lse, g, layout)
        e_lse = (lse - ref_lse).abs().max().item()
        e = {name: ((got.float() - want.float()).abs().max().item(),
                    want.float().abs().max().item())
             for name, got, want in (("dh", dh, ref_dh), ("dw", dw, ref_dw),
                                     ("db", db, ref_db))}
        log(f"check n={n} v={v} layout={layout} bias={bias}: lse {e_lse:.3g}; "
            + "; ".join(f"{k} {err:.3g} (max {m:.3g})" for k, (err, m) in e.items()))
        ok = math.isfinite(e_lse) and e_lse <= LSE_ATOL and all(
            math.isfinite(err) and err <= GRAD_RTOL_OF_MAX * m for err, m in e.values())
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at n={n} "
                                 f"v={v} layout={layout} bias={bias}")
        errs["xent_fwd"] = max(errs["xent_fwd"], e_lse)
        errs["xent_dh"] = max(errs["xent_dh"], e["dh"][0])
        errs["xent_dwdb"] = max(errs["xent_dwdb"], e["dw"][0], e["db"][0])
    return errs


def time_kernels(fx, dev):
    """Phase 3b: each kernel at the flagship micro-batch, as the main path
    calls it ("dv" table, no bias, g = 1/N from the mean loss)."""
    gen = torch.Generator().manual_seed(1)
    n = FLAGSHIP_ROWS
    h, w, _, _ = inputs(n, V, "dv", False, gen, dev)
    g = torch.full((n,), 1.0 / n, device=dev)
    lse = fx.xent_fwd(h, w, None)
    in_bytes = n * D * 2 + D * V * 4
    ops = 2.0 * n * D * V
    rows = {
        "xent_fwd": dict(ms=time_ms(lambda: fx.xent_fwd(h, w, None), 3),
                         plain_ms=time_ms(lambda: fx.matmul_logsumexp_plain(h, w, None), 1),
                         library_ms=time_ms(
                             lambda: torch.logsumexp(h @ w.to(h.dtype), -1), 3),
                         bound=bound(in_bytes + n * 4, ops)),
        "xent_dh": dict(ms=time_ms(lambda: fx.xent_dh(h, w, None, lse, g), 3),
                        bound=bound(in_bytes + 2 * n * 4 + n * D * 2, 2 * ops)),
        "xent_dwdb": dict(ms=time_ms(lambda: fx.xent_dwdb(h, w, None, lse, g), 3),
                          bound=bound(in_bytes + 2 * n * 4 + D * V * 4 + V * 4, 2 * ops)),
    }
    # One plain call computes dh, dw and db together: its time stands for both.
    plain_bwd = time_ms(lambda: fx.lse_backward_plain(h, w, None, lse, g), 1)
    rows["xent_dh"].update(plain_ms=plain_bwd, library_ms=None)
    rows["xent_dwdb"].update(plain_ms=plain_bwd, library_ms=None)
    for name, r in rows.items():
        log(f"time {name} N={n}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']} ms, bound {r['bound'][0]:.3f} ms "
            f"({r['bound'][1]})")
    # The main path's own micro-batch, for the step-time breakdown.
    m = MAIN_MICRO_ROWS
    hm, lm, gm = h[:m], lse[:m], torch.full((m,), 1.0 / m, device=dev)
    log(f"time at the main path's N={m}: "
        f"xent_fwd {time_ms(lambda: fx.xent_fwd(hm, w, None), 5):.3f} ms, "
        f"xent_dh {time_ms(lambda: fx.xent_dh(hm, w, None, lm, gm), 5):.3f} ms, "
        f"xent_dwdb {time_ms(lambda: fx.xent_dwdb(hm, w, None, lm, gm), 5):.3f} ms")
    return rows


def main_path(fx, dev):
    """Phase 4: the flagship training step through the port's entry points."""
    from autodist_tpu_torch import AllReduce, AutoDist
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    micro, accum, seq, steps = 32, 2, 256, 3
    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6,
                                  d_ff=2048, max_len=512, fused_head=True,
                                  tied_output=False, dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)

    # Reference on a small input: fused head (kernels) vs plain logits head.
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 4, seq, seed=99).items()}
    plain_model = tlm.TransformerLM(dataclasses.replace(cfg, fused_head=False))
    with torch.no_grad():
        fused = float(tlm.make_loss_fn(model)(params, small))
        plain = float(tlm.make_loss_fn(plain_model)(params, small))
    log(f"reference: fused-head loss {fused:.6f} vs logits-head loss {plain:.6f}")
    if not (math.isfinite(fused) and abs(fused - plain) <= 1e-2 * abs(plain)):
        raise AssertionError("fused-head loss disagrees with the logits head")

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce())
    batches = [tlm.synthetic_batch(cfg, micro * accum, seq, seed=i) for i in range(steps)]
    step = ad.function(tlm.make_loss_fn(model), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                       example_batch=batches[0], accumulation_steps=accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fx.KERNELS:
        k.launches = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))       # float() waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in fx.KERNELS}
    log(f"main path: losses {losses}; step seconds {times}")
    log(f"main path: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    # Throughput over more steady steps than the counted run has, then a trace.
    more = [tlm.synthetic_batch(cfg, micro * accum, seq, seed=steps + i)
            for i in range(STEADY_STEPS + PROFILE_STEPS)]
    t0 = time.perf_counter()
    for batch in more[:STEADY_STEPS]:
        float(step(batch))
    per_step = (time.perf_counter() - t0) / STEADY_STEPS
    tokens = micro * accum * seq
    flops = transformer_flops_per_token(D, 6, 2048, V, seq) * tokens
    log(f"main path: {tokens / per_step:.1f} tokens/s over {STEADY_STEPS} steady steps "
        f"({tokens} tokens/step, {1e3 * per_step:.3f} ms/step), MFU "
        f"{mfu(flops / per_step):.4f} of 989 TFLOP/s")
    profile_steps(step, more[STEADY_STEPS:])
    return launches


def profile_steps(step, batches):
    """Phase 4b: a torch.profiler window over steady steps of the main path:
    device busy time per step (the union of kernel intervals), the device's
    idle share of the wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            float(step(batch))
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    n = len(batches)
    if not kernels:
        log("profile: the profiler recorded no device time; busy and idle share "
            "not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    per_name = collections.Counter()
    for e in kernels:
        per_name[e.name] += e.time_range.elapsed_us()
    head_us = sum(us for name, us in per_name.items() if "xent_" in name)
    log(f"profile: {n} steps, {1e3 * wall / n:.3f} ms/step wall with the profiler on; "
        f"device busy {busy_us / n / 1e3:.3f} ms/step, idle share "
        f"{1 - busy_us / 1e6 / wall:.3f}; {len(kernels) // n} kernels/step; "
        f"fused-head kernels {head_us / n / 1e3:.3f} ms/step")
    for name, us in per_name.most_common(8):
        log(f"profile:   {us / n / 1e3:8.3f} ms/step  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import _build
    from autodist_tpu_torch.ops import fused_xent as fx

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: float32 matmuls run in full float32")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    errs = check_kernels(fx, dev)
    timing = time_kernels(fx, dev)
    launches = main_path(fx, dev)

    source = "autodist_tpu_torch/ops/csrc/fused_xent.cu"
    replaces = {"xent_fwd": "autodist_tpu/ops/fused_xent.py:192",
                "xent_dh": "autodist_tpu/ops/fused_xent.py:287",
                "xent_dwdb": "autodist_tpu/ops/fused_xent.py:305"}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound"][0],
                "bound_by": timing[name]["bound"][1],
                "library_ms": timing[name]["library_ms"]} for name in replaces]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
