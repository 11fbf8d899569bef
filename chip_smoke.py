#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build its CUDA kernels, hold each against
its plain version on the card, and train the flagship TransformerLM through
the port's entry points on one card, at seq 256, at seq 8,192, and at seq
8,192 through the sequence-parallel path (a ring of one card).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and ``nvcc``;
exits non-zero without them, or when any phase fails. Phases:

1. The card's name and power limit (``nvidia-smi``), TF32 off.
2. Build every kernel source of the port into ``build/`` (timed); print
   each kernel's registers, barriers, stack and spills from ``-Xptxas -v``,
   any ptxas warning, and the forward kernels' dynamic shared memory. A
   serialized-wgmma warning (C7518-C7520, C7512, ...) fails the phase.
3. Each fused-LM-head kernel against its plain version on the same inputs:
   D = 512 with bf16 activations and an f32 table, both table layouts, with
   and without a bias, ragged N and V (1,000 x 31,999), the forward and dh
   kernels' tiling edges (``XENT_EDGES``: N one short of and one past the
   forward's 128-row and dh's 64-row blocks, V one past the forward's
   128-column and dh's 64-column vocab tiles, every such V odd, so the
   packed "dv" table is padded), and the main paths' own shapes ("dv", no
   bias, V = 32,000): N = 8,192 (the flagship micro-batch here) and 65,536
   (the long-context step). The pack kernel must equal its plain version
   bit for bit. Tolerance: lse within 0.01 absolute; dh, dw and db within
   TILE_RTOL in every tile (see ``worst_tile``). Then each kernel is timed
   at the flagship micro-batch (N = 98,304) beside its plain version, the
   one PyTorch call computing the same function where there is one, and its
   bound, with the TFLOP/s reached and the share of the bound; and the pack
   beside its bytes' bound.
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
5. Each flash-attention kernel against its plain version on the same
   inputs: bf16 q/k/v/dO [B, L, 8, 64], B = 2 at a ragged L = 1,000 causal
   and not causal, with ring offsets (q_offset 1,024, with bf16 and with
   f32 gradient outputs; k_offset 300 and 700, where the first 300 or 700
   query rows see no key and the last 300 or 700 keys no query: those
   rows of dq and keys of dk and dv must come out exactly 0, in bf16 and
   in f32), the forward's tiling edges (L = 129, 193 and 8,191, causal and
   not: one row past a 128- and a 192-row block, one short of the path's
   length), the backward's (L = 63, 65, 127, 129, 191 and 193: one short
   of and one past a 64-row tile, a 128-key dK/dV block and a 192-row dQ
   block), and the long-context path's own shape, B = 8 at L = 8,192,
   causal. Tolerance: lse within FLASH_LSE_ATOL absolute; out, dq, dk and
   dv within TILE_RTOL in every tile. Then each kernel is timed at the
   long-context shape (B = 8, L = 8,192, H = 8, hd = 64, causal) beside its
   plain version, its bound (with the TFLOP/s reached and the share of the
   bound) and a library yardstick the port never calls
   (``F.scaled_dot_product_attention(is_causal=True)``, and that call's
   backward for dK/dV and dQ together, which computes its own D: it is
   set beside the pair, and beside ``prepare_backward_q_side`` and the
   pair).
6. The long-context entry point (``autodist_tpu_torch.examples.long_context_lm``)
   at full width: d512 x 6 layers, 8 heads, d_ff 2048, vocab 32,000, seq =
   max_len = 8,192, flash attention, every block rematerialized, untied
   fused head, bf16 activations, f32 params, ``AllReduce``, Adam 1e-3. The
   batch is cut to 8 sequences (65,536 tokens a step) from the example's
   default 48. First, on B = 2, L = 1,024, the flash model's loss is held
   against the dot model's with the same weights (rtol 1e-2: bf16). Then 3
   counted steps (launch counts set to 0 just before, read just after; all
   six kernels must have launched, all losses finite), the entry point's
   own ``main`` for tokens/s and MFU over 4 steady steps with peak memory,
   and a profiler window over 2 steps.
7. The flash carry kernel (ring attention's local step) against its plain
   version: ragged L = 1,000 with no carry in, a past shard with a carry in
   (q_offset 1,024, k_offset 0), a diagonal step with a carry in, steps
   whose first 100, 150, 200 or 300 rows see no key (the block that holds
   the boundary is part pass-through, the boundary in each consumer
   warpgroup's rows in turn; those rows' carry must come out bit for bit as
   it went in), the tiling edges L = 129, 193 and 8,191 (causal and not,
   and with a carry in), and the path's own shapes, B = 8 at L_local =
   8,192 (the one-card ring) and 2,048 (with a carry in). Tolerance: acc and
   l within TILE_RTOL in every tile of rows, m within FLASH_LSE_ATOL. Then
   the ring's arithmetic on one card: B = 8, L = 8,192 split into 4 shards,
   the forward ring schedule with the carry kernel, the backward schedule
   with the dK/dV and dQ kernels (offsets, f32 outputs) summed as the ring
   sums them, against ``flash_forward_plain``/``flash_backward_plain`` on the
   whole sequence, tile by tile (lse within FLASH_LSE_ATOL). Then the carry
   kernel is timed at B = 8, L = 8,192 as the one-card ring calls it (no
   carry in) beside its plain version, its bound and
   ``F.scaled_dot_product_attention(is_causal=True)``, which lacks the
   carry merge.
8. Sequence-parallel training at full width (d512 x 6 layers, 8 heads, d_ff
   2048, vocab 32,000, seq = max_len = 8,192, B = 8, ring attention, every
   block rematerialized, untied fused head, bf16 activations, f32 params,
   Adam 1e-3) through ``create_sequence_parallel_session(AutoDist(
   resource_info=ONE_CARD, strategy_builder=SequenceParallel(seq_axis_size=1)),
   ...)``. First, on B = 2, L = 1,024, the ring model's loss is held against
   the flash model's with the same weights (rtol 1e-2). Then 3 counted
   steps (every kernel but ``flash_fwd`` must launch, ``flash_fwd`` never;
   all losses finite), tokens/s and MFU over 4 steady steps with peak
   memory, and a profiler window over 2 steps.
9. One JSON line of per-kernel numbers (all seven kernels), then the result
   line.
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
# Every output is held tile by tile: ||got - want|| / ||want|| over each
# 64-long tile of the dimension a kernel's block owns (rows, keys or vocab
# columns), split by batch and head, at most TILE_RTOL. The kernels and their
# plain versions round the same operands to bf16, so what is left is another
# f32 summation order and one bf16 rounding of the stored result (2^-9
# relative). A tile left unwritten, zeroed or unscaled reads about 1.
TILE = 64
TILE_RTOL = 1e-2
STEADY_STEPS = 6                  # steps timed for throughput after the counted run
PROFILE_STEPS = 3                 # steps traced after those

# Long-context slice: flash attention at the example's sequence length.
LC_SEQ, LC_BATCH, LC_HEADS, HEAD_DIM = 8192, 8, 8, 64
FLASH_LSE_ATOL = 1e-3
LC_COUNTED, LC_STEADY, LC_PROFILE = 3, 4, 2
RING_SHARDS = 4                   # shards of the ring replay on one card
# The forward kernels' blocks hold 192 query rows, 64 per consumer
# warpgroup; their key tiles 128 keys. Lengths one past a 128- and a
# 192-row block and one short of the long-context length, and k_offsets
# whose first visible row falls in each consumer's rows of a block.
EDGE_LENGTHS = (129, 193, LC_SEQ - 1)
EDGE_K_OFFSETS = (100, 150, 200, 300)
# The backward kernels stream 64-row tiles; dK/dV blocks hold 128 keys (two
# consumers of 64), dQ blocks 192 query rows (three of 64): lengths one
# short of and one past each.
BWD_EDGE_LENGTHS = (63, 65, 127, 129, 191, 193)
# ptxas's "wgmma serialized" warnings (C7518-C7520: a wgmma on a divergent
# path; C7512: too few registers): a kernel that shows one runs every wgmma
# one after the other.
SERIALIZED_WGMMA = ("wgmma", "serialized")
# The fused-head forward's blocks hold 128 rows and walk 128-column vocab
# tiles, dh's 64 rows and 64-column tiles: (N, V) one short of or one past
# each, every V odd (the packed "dv" table's row stride is padded to 8).
XENT_EDGES = ((127, 129), (129, 65), (63, 129), (65, 65))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str):
    """One line per kernel instantiation from ``-Xptxas -v``: its name,
    registers, barriers, static shared memory, stack and spills; and every
    ptxas warning (a serialized wgmma among them)."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line:
            mangled = line.split("for ", 1)[1].strip()
            kernel = next((k for k in ("flash_fwd_carry_kernel", "flash_fwd_kernel",
                                       "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                                       "xent_fwd_kernel", "xent_dh_kernel", "xent_dwdb_kernel",
                                       "xent_pack_kernel")
                           if k in mangled), mangled)
            frame = lines[i + 1].strip() if i + 1 < len(lines) else ""
            used = lines[i + 2].split("Used", 1)[-1].strip() if i + 2 < len(lines) else ""
            yield f"{kernel}: {used}; {frame}"
        elif "Performance Loss" in line or "warning" in line.lower():
            yield line.strip()


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


def rate(r) -> str:
    """A timed row's achieved tensor-core TFLOP/s and the share of its bound
    reached (bound / time); stored in the row for the JSON line too."""
    r["tflops"] = r["flops"] / (r["ms"] * 1e-3) / 1e12
    r["bound_share"] = r["bound"][0] / r["ms"]
    return f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound"


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
    cases += [(n, v, layout, bias) for n, v in XENT_EDGES for layout in ("dv", "vd")
              for bias in (True, False)]
    cases += [(MAIN_MICRO_ROWS, V, "dv", False), (LC_BATCH * LC_SEQ, V, "dv", False)]
    for n, v, layout, bias in cases:
        h, w, b, g = inputs(n, v, layout, bias, gen, dev)
        packed = fx.xent_pack_w(w, layout)
        torch.cuda.synchronize()
        if not torch.equal(packed, fx.pack_w_plain(w, layout)):
            raise AssertionError(f"the pack kernel disagrees with its plain version at v={v} "
                                 f"layout={layout}")
        lse = fx.xent_fwd(h, w, b, layout)
        dh = fx.xent_dh(h, w, b, lse, g, layout)
        dw, db = fx.xent_dwdb(h, w, b, lse, g, layout)
        torch.cuda.synchronize()
        ref_lse = fx.matmul_logsumexp_plain(h, w, b, layout)
        ref_dh, ref_dw, ref_db = fx.lse_backward_plain(h, w, b, lse, g, layout)
        e_lse = (lse - ref_lse).abs().max().item()
        v_dim = 0 if layout == "vd" else 1
        e = {name: compare(got, want, dim)
             for name, got, want, dim in (("dh", dh, ref_dh, 0), ("dw", dw, ref_dw, v_dim),
                                          ("db", db, ref_db, 0))}
        log(f"check n={n} v={v} layout={layout} bias={bias}: lse {e_lse:.3g}; "
            + "; ".join(f"{k} {describe(c)}" for k, c in e.items()))
        ok = math.isfinite(e_lse) and e_lse <= LSE_ATOL and all(
            c[2] <= TILE_RTOL for c in e.values())
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at n={n} "
                                 f"v={v} layout={layout} bias={bias}")
        errs["xent_fwd"] = max(errs["xent_fwd"], e_lse)
        errs["xent_dh"] = max(errs["xent_dh"], e["dh"][0])
        errs["xent_dwdb"] = max(errs["xent_dwdb"], e["dw"][0], e["db"][0])
    return errs


def worst_tile(got, want, dim):
    """The largest ``||got - want|| / ||want||`` over tiles of TILE entries
    along ``dim`` (the dimension a kernel block owns). A tile spans the last
    dimension (the head or model width) and is split by every other one
    (batch, head), so one wrong block shows however small its share of the
    whole. A tile whose reference is 0 must come out 0 (inf otherwise)."""
    def norms(x):
        x = x.float().movedim(dim, 0)
        if x.dim() == 1:
            x = x[:, None]
        x = torch.cat([x, x.new_zeros(-x.shape[0] % TILE, *x.shape[1:])])
        x = x.reshape(-1, TILE, *x.shape[1:])
        return torch.linalg.vector_norm(x, dim=(1, -1))
    err, ref = norms(got.float() - want.float()), norms(want)
    ratio = torch.where(ref > 0, err / ref.clamp(min=1e-30),
                        torch.where(err > 0, math.inf, 0.0))
    return ratio.max().item()


def compare(got, want, dim):
    """``(max |got - want|, max |want|, worst tile ratio)``; NaN counts as inf."""
    diff = (got.float() - want.float()).abs().max().item()
    worst = worst_tile(got, want, dim)
    return diff, want.float().abs().max().item(), worst if math.isfinite(worst) else math.inf


def describe(c):
    return f"{c[0]:.3g} (max {c[1]:.3g}, worst tile {c[2]:.3g})"


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
        "xent_fwd": dict(flops=ops, ms=time_ms(lambda: fx.xent_fwd(h, w, None), 3),
                         plain_ms=time_ms(lambda: fx.matmul_logsumexp_plain(h, w, None), 1),
                         library_ms=time_ms(
                             lambda: torch.logsumexp(h @ w.to(h.dtype), -1), 3),
                         bound=bound(in_bytes + n * 4, ops)),
        "xent_dh": dict(flops=2 * ops, ms=time_ms(lambda: fx.xent_dh(h, w, None, lse, g), 3),
                        bound=bound(in_bytes + 2 * n * 4 + n * D * 2, 2 * ops)),
        "xent_dwdb": dict(flops=2 * ops,
                          ms=time_ms(lambda: fx.xent_dwdb(h, w, None, lse, g), 3),
                          bound=bound(in_bytes + 2 * n * 4 + D * V * 4 + V * 4, 2 * ops)),
    }
    # One plain call computes dh, dw and db together: its time stands for both.
    plain_bwd = time_ms(lambda: fx.lse_backward_plain(h, w, None, lse, g), 1)
    rows["xent_dh"].update(plain_ms=plain_bwd, library_ms=None)
    rows["xent_dwdb"].update(plain_ms=plain_bwd, library_ms=None)
    for name, r in rows.items():
        log(f"time {name} N={n}: kernel {r['ms']:.3f} ms ({rate(r)}), plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.3f} ms ({r['bound'][1]})")
    # The pack runs inside the forward's and dh's wrappers, so their times
    # above include it: f32 w read once, bf16 w written once.
    pack_ms = time_ms(lambda: fx.xent_pack_w(w), 10)
    log(f"time xent_pack_w D={D} V={V} (dv): {pack_ms:.3f} ms, plain "
        f"{time_ms(lambda: fx.pack_w_plain(w), 10):.3f} ms, bound "
        f"{bound(D * V * 6, 0)[0]:.3f} ms (bytes)")
    # The main path's own micro-batch, for the step-time breakdown.
    m = MAIN_MICRO_ROWS
    hm, lm, gm = h[:m], lse[:m], torch.full((m,), 1.0 / m, device=dev)
    log(f"time at the main path's N={m}: "
        f"xent_fwd {time_ms(lambda: fx.xent_fwd(hm, w, None), 5):.3f} ms, "
        f"xent_dh {time_ms(lambda: fx.xent_dh(hm, w, None, lm, gm), 5):.3f} ms, "
        f"xent_dwdb {time_ms(lambda: fx.xent_dwdb(hm, w, None, lm, gm), 5):.3f} ms")
    return rows


def main_path(kernels, dev):
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
    losses, times, launches = counted_steps(step, batches, kernels)
    log(f"main path: losses {losses}; step seconds {times}")
    log(f"main path: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items()
               if count == 0 and name.startswith("xent_")]
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


def counted_steps(step, batches, kernels):
    """One step per batch with every launch count set to 0 just before and
    read just after: ``(losses, step seconds, {kernel: launches})``. Fails
    on a non-finite loss."""
    for k in kernels:
        k.launches = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))       # float() waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, times, launches


def profile_steps(step, batches, label="profile"):
    """A torch.profiler window over steady steps of a main path: device busy
    time per step (the union of kernel intervals), the device's idle share
    of the wall time, the port's kernels and the kernels that take the most."""
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
        log(f"{label}: the profiler recorded no device time; busy and idle share "
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
    flash_us = sum(us for name, us in per_name.items() if "flash_" in name)
    log(f"{label}: {n} steps, {1e3 * wall / n:.3f} ms/step wall with the profiler on; "
        f"device busy {busy_us / n / 1e3:.3f} ms/step, idle share "
        f"{1 - busy_us / 1e6 / wall:.3f}; {len(kernels) // n} kernels/step; "
        f"fused-head kernels {head_us / n / 1e3:.3f} ms/step, flash kernels "
        f"{flash_us / n / 1e3:.3f} ms/step")
    for name, us in per_name.most_common(10):
        log(f"{label}:   {us / n / 1e3:8.3f} ms/step  {name[:110]}")


def flash_inputs(b, lq, lk, gen, dev):
    """bf16 q [b, lq, 8, 64], k/v [b, lk, 8, 64] and dO like q."""
    def draw(length, std=1.0):
        return (torch.randn(b, length, LC_HEADS, HEAD_DIM, generator=gen) * std).to(
            dev, torch.bfloat16)
    return draw(lq), draw(lk), draw(lk), draw(lq, 0.1)


def check_flash(fa, dev):
    """Phase 5a: every flash kernel against its plain version; max abs errors."""
    gen = torch.Generator().manual_seed(2)
    errs = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    cases = [  # (b, lq, lk, causal, q_offset, k_offset, backward out_dtype)
        (2, 1000, 1000, True, 0, 0, None),
        (2, 1000, 1000, False, 0, 0, None),
        (2, 1000, 1000, True, 1024, 0, None),
        (2, 1000, 1000, True, 1024, 0, torch.float32),
        (2, 1000, 1000, True, 0, 300, torch.float32),
        (2, 1000, 1000, True, 0, 300, None),
        (2, 1000, 1000, True, 0, 700, torch.float32),
        (LC_BATCH, LC_SEQ, LC_SEQ, True, 0, 0, None),
    ]
    # The forward's tiling edges: one row past a 128-row and a 192-row block
    # (the last block's rows end in its second or its first consumer), and
    # one row short of the long-context length; and the backward's.
    cases += [(2, n, n, causal, 0, 0, None)
              for n in sorted(set(EDGE_LENGTHS + BWD_EDGE_LENGTHS)) for causal in (True, False)]
    for b, lq, lk, causal, qo, ko, out_dtype in cases:
        q, k, v, do = flash_inputs(b, lq, lk, gen, dev)
        out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
        dd = fa.prepare_backward_q_side(out, do)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
        ref = fa.flash_backward_plain(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        e_lse = (lse - ref_lse).abs().max().item()
        # Forward and dQ blocks own query rows, dK/dV blocks keys: dim 1 of
        # [B, L, H, 64] either way.
        e = {name: compare(got, want, 1)
             for name, got, want in (("out", out, ref_out), ("dq", dq, ref[0]),
                                     ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
        if out_dtype is not None and any(t.dtype != out_dtype for t in (dq, dk, dv)):
            raise AssertionError("flash backward ignored out_dtype")
        log(f"check flash b={b} lq={lq} lk={lk} causal={causal} offsets=({qo}, {ko}) "
            f"out_dtype={out_dtype}: lse {e_lse:.3g}; "
            + "; ".join(f"{n} {describe(c)}" for n, c in e.items()))
        ok = (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL
              and all(c[2] <= TILE_RTOL for c in e.values()))
        # Query rows that see no key, and keys that no query sees: exactly 0.
        blind = min(lq, max(0, ko - qo)) if causal else 0
        unseen = min(lk, max(0, qo - ko + lq)) if causal else lk
        if blind or unseen < lk:
            zero = not (dq[:, :blind].any() or dk[:, unseen:].any() or dv[:, unseen:].any())
            log(f"check flash: dq rows 0-{blind - 1} and dk, dv keys {unseen}-{lk - 1} "
                f"exactly 0: {zero}")
            ok = ok and zero
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at b={b} "
                                 f"lq={lq} lk={lk} causal={causal} offsets=({qo}, {ko})")
        errs["flash_fwd"] = max(errs["flash_fwd"], e["out"][0], e_lse)
        errs["flash_bwd_dkdv"] = max(errs["flash_bwd_dkdv"], e["dk"][0], e["dv"][0])
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dq"][0])
    return errs


def time_flash(fa, dev):
    """Phase 5b: each flash kernel at the long-context shape, causal, as the
    main path calls it, beside its plain version, its bound and the library
    call computing the same function."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    b, length = LC_BATCH, LC_SEQ
    q, k, v, do = flash_inputs(b, length, length, gen, dev)
    out, lse = fa.flash_fwd(q, k, v)
    dd = fa.prepare_backward_q_side(out, do)
    # Tensor-core FLOPs over the causal half of the scores: 2 products in the
    # forward (S, PV), 4 in dK/dV (S, dP, dV, dK), 3 in dQ (S, dP, dQ).
    pairs = length * (length + 1) / 2
    per_product = 2.0 * b * LC_HEADS * pairs * HEAD_DIM
    act = b * length * LC_HEADS * HEAD_DIM * 2          # one bf16 [B, L, H, 64]
    row = b * LC_HEADS * length * 4                     # one f32 [B*H, L]
    rows = {
        "flash_fwd": dict(flops=2 * per_product, ms=time_ms(lambda: fa.flash_fwd(q, k, v), 10),
                          plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v), 1),
                          bound=bound(4 * act + row, 2 * per_product)),
        "flash_bwd_dkdv": dict(
            flops=4 * per_product, ms=time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, dd), 5),
            bound=bound(4 * act + 2 * row + 2 * act, 4 * per_product)),
        "flash_bwd_dq": dict(
            flops=3 * per_product, ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd), 5),
            bound=bound(4 * act + 2 * row + act, 3 * per_product)),
    }
    # One plain call computes dq, dk and dv together: its time stands for both.
    plain_bwd = time_ms(lambda: fa.flash_backward_plain(q, k, v, do, lse, dd), 1)
    # The yardstick: PyTorch's fused attention on the same tensors ([B, H, L, D] views).
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    rows["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                  retain_graph=True), 5)
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        rows[name].update(plain_ms=plain_bwd, library_ms=lib_bwd)
    for name, r in rows.items():
        log(f"time {name} B={b} L={length} H={LC_HEADS} hd={HEAD_DIM}: kernel "
            f"{r['ms']:.3f} ms ({rate(r)}), plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]})")
    # The library's backward computes its own D: set it beside the pair
    # alone and beside D's pass and the pair, as _FlashAttention.backward runs them.
    def pair():
        fa.flash_bwd_dkdv(q, k, v, do, lse, dd)
        fa.flash_bwd_dq(q, k, v, do, lse, dd)

    def with_d():
        d = fa.prepare_backward_q_side(out, do)
        fa.flash_bwd_dkdv(q, k, v, do, lse, d)
        fa.flash_bwd_dq(q, k, v, do, lse, d)
    pair_bound = rows["flash_bwd_dkdv"]["bound"][0] + rows["flash_bwd_dq"]["bound"][0]
    log(f"time flash backward pair B={b} L={length}: {time_ms(pair, 5):.3f} ms (bound "
        f"{pair_bound:.3f} ms), with prepare_backward_q_side {time_ms(with_d, 5):.3f} ms; "
        f"library backward (its own D included) {lib_bwd:.3f} ms")
    return rows


def long_context_path(kernels, dev):
    """Phase 6: long-context training through the port's entry point."""
    from autodist_tpu_torch.examples import long_context_lm as lc
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    argv = ["--seq_len", str(LC_SEQ), "--batch_size", str(LC_BATCH), "--device", str(dev)]
    cfg, step, batch = lc.build(lc.parse_args(argv))
    log(f"long context: {cfg}")

    # Reference on a small input: flash (kernels) vs dot attention, same weights.
    params = step.get_state().params
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 2, min(1024, LC_SEQ), seed=98).items()}
    dot_cfg = dataclasses.replace(cfg, attention_impl="dot", remat=False)
    with torch.no_grad():
        flash = float(tlm.make_loss_fn(tlm.TransformerLM(cfg))(params, small))
        dot = float(tlm.make_loss_fn(tlm.TransformerLM(dot_cfg))(params, small))
    log(f"long-context reference: flash loss {flash:.6f} vs dot loss {dot:.6f}")
    if not (math.isfinite(flash) and abs(flash - dot) <= 1e-2 * abs(dot)):
        raise AssertionError("flash-attention loss disagrees with dot attention")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC_COUNTED, kernels)
    tokens = batch["tokens"].shape[0] * LC_SEQ
    log(f"long context: losses {losses}; step seconds {times}")
    log(f"long context: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items()
               if count == 0 and name != "flash_fwd_carry"]
    if missing:
        raise AssertionError(f"long-context path never launched {missing}")

    # The entry point's own run: one warm-up step, then LC_STEADY timed ones.
    torch.cuda.reset_peak_memory_stats()
    rate = lc.main(argv + ["--steps", str(LC_STEADY)])
    flops = transformer_flops_per_token(D, 6, 2048, V, LC_SEQ) * tokens
    log(f"long context: {rate:.1f} tokens/s over {LC_STEADY} steady steps "
        f"({tokens} tokens/step, {1e3 * tokens / rate:.3f} ms/step), MFU "
        f"{mfu(flops * rate / tokens):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(step, [batch] * LC_PROFILE, label="long-context profile")
    return launches


def carry_case(fa, q, k, v, carry, qo, ko, causal=True):
    """The carry kernel and its plain version on the same inputs; returns
    ``(worst tile of acc, of l, max |m - m_ref|, kernel's (acc, m, l))``."""
    got = fa.flash_fwd_carry(q, k, v, carry, causal, qo, ko)
    torch.cuda.synchronize()
    want = fa.flash_forward_carry_plain(q, k, v, carry, causal, qo, ko)
    e_acc = compare(got[0], want[0], 2)
    e_l = compare(got[2][..., None], want[2][..., None], 2)
    e_m = (got[1] - want[1]).abs().max().item()
    return e_acc, e_l, e_m, got


def check_carry(fa, dev):
    """Phase 7a: the carry kernel against its plain version; max abs error."""
    gen = torch.Generator().manual_seed(4)
    err = 0.0
    q, k, v, _ = flash_inputs(2, 1000, 1000, gen, dev)
    _, k_prev, v_prev, _ = flash_inputs(2, 1000, 1000, gen, dev)
    # A carry as the ring hands it on: this shard's diagonal step (and, for
    # the diagonal case, a past shard's step) done by the plain version.
    diag = fa.flash_forward_carry_plain(q, k, v, None, True, 1024, 1024)
    past = fa.flash_forward_carry_plain(q, k_prev, v_prev, None, True, 1024, 0)
    cases = [  # (label, q, k, v, carry, q_offset, k_offset, causal)
        ("ragged, no carry", q, k, v, None, 0, 0, True),
        ("past shard, carry in", q, k_prev, v_prev, diag, 1024, 0, True),
        ("diagonal, carry in", q, k, v, past, 1024, 1024, True),
    ]
    # Rows 0 .. ko - 1 see no key; the block holding row ko is part
    # pass-through, with the boundary in each consumer's rows in turn.
    cases += [(f"rows 0-{ko - 1} see no key, carry in", q, k, v, diag, 0, ko, True)
              for ko in EDGE_K_OFFSETS]
    for n in EDGE_LENGTHS:
        qe, ke, ve, _ = flash_inputs(2, n, n, gen, dev)
        for causal in (True, False):
            cases.append((f"edge, no carry, causal={causal}", qe, ke, ve, None, 0, 0, causal))
        cin = fa.flash_forward_carry_plain(qe, ke, ve, None, True, n, n)
        cases.append(("edge, carry in, causal=False", qe, ke, ve, cin, n, 0, False))
    for b, length, carry in ((LC_BATCH, LC_SEQ, False),
                             (LC_BATCH, LC_SEQ // RING_SHARDS, True)):
        qb, kb, vb, _ = flash_inputs(b, length, length, gen, dev)
        cin = fa.flash_forward_carry_plain(qb, kb, vb, None, True, length, length) \
            if carry else None
        cases.append((f"path shape B={b} L={length}", qb, kb, vb, cin,
                      length if carry else 0, 0, True))
    for label, q_, k_, v_, cin, qo, ko, causal in cases:
        e_acc, e_l, e_m, got = carry_case(fa, q_, k_, v_, cin, qo, ko, causal)
        log(f"check flash carry {label} b={q_.shape[0]} L={q_.shape[1]} offsets=({qo}, {ko}): "
            f"acc {describe(e_acc)}; l {describe(e_l)}; m {e_m:.3g}")
        ok = (e_acc[2] <= TILE_RTOL and e_l[2] <= TILE_RTOL and math.isfinite(e_m)
              and e_m <= FLASH_LSE_ATOL)
        blind = ko - qo if causal and cin is not None else 0   # rows that see no key
        if blind > 0:
            same = all(torch.equal(g[:, :, :blind], c[:, :, :blind]) for g, c in zip(got, cin))
            log(f"check flash carry: rows 0-{blind - 1} without a key carried through "
                f"bit-equal: {same}")
            ok = ok and same
        if not ok:
            raise AssertionError(f"carry kernel disagrees with its plain version: {label}")
        err = max(err, e_acc[0], e_l[0], e_m)
    return {"flash_fwd_carry": err}


def check_ring_replay(fa, dev):
    """Phase 7b: the ring's arithmetic on one card. B = 8, L = 8,192 in 4
    shards: the forward ring schedule chains the carry kernel, the backward
    schedule sums the f32 dK/dV and dQ kernels' parts as the ring does;
    out, lse, dq, dk and dv against the plain versions on the whole sequence."""
    gen = torch.Generator().manual_seed(5)
    n, length = RING_SHARDS, LC_SEQ
    ll = length // n
    q, k, v, do = flash_inputs(LC_BATCH, length, length, gen, dev)
    shard = [slice(r * ll, (r + 1) * ll) for r in range(n)]
    qs, ks, vs, dos = ([x[:, s].contiguous() for s in shard] for x in (q, k, v, do))
    outs, lses = [], []
    for r in range(n):
        carry = None
        for step in range(n):                        # ring order, causal steps only
            src = (r - step) % n
            if step == 0 or src <= r:
                carry = fa.flash_fwd_carry(qs[r], ks[src], vs[src], carry, True, r * ll, src * ll)
        acc, m, l = carry
        l = l.clamp(min=1e-30)
        outs.append((acc / l[..., None]).transpose(1, 2).to(torch.bfloat16).contiguous())
        lses.append((m + torch.log(l)).reshape(-1, ll))
    f32 = torch.float32
    dq = [torch.zeros(x.shape, dtype=f32, device=dev) for x in qs]
    dk = [torch.zeros(x.shape, dtype=f32, device=dev) for x in ks]
    dv = [torch.zeros(x.shape, dtype=f32, device=dev) for x in vs]
    for src in range(n):                             # K/V shard src travels r = src .. n-1
        for r in range(src, n):
            dd = fa.prepare_backward_q_side(outs[r], dos[r])
            a, b = fa.flash_bwd_dkdv(qs[r], ks[src], vs[src], dos[r], lses[r], dd, True,
                                     r * ll, src * ll, f32)
            dk[src] += a
            dv[src] += b
            dq[r] += fa.flash_bwd_dq(qs[r], ks[src], vs[src], dos[r], lses[r], dd, True,
                                     r * ll, src * ll, f32)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v)
    ref_dd = fa.prepare_backward_q_side(ref_out, do)
    ref = fa.flash_backward_plain(q, k, v, do, ref_lse, ref_dd, out_dtype=f32)
    lse = torch.cat(lses, dim=1)
    e_lse = (lse - ref_lse).abs().max().item()
    e = {name: compare(torch.cat(got, dim=1), want, 1)
         for name, got, want in (("out", outs, ref_out), ("dq", dq, ref[0]),
                                 ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
    log(f"check ring replay B={LC_BATCH} L={length} in {n} shards: lse {e_lse:.3g}; "
        + "; ".join(f"{name} {describe(c)}" for name, c in e.items()))
    if not (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL
            and all(c[2] <= TILE_RTOL for c in e.values())):
        raise AssertionError("the ring replay disagrees with the whole-sequence plain versions")
    return max(e_lse, e["out"][0])


def time_carry(fa, dev):
    """Phase 7c: the carry kernel at B = 8, L = 8,192 as the one-card ring
    calls it (no carry in), beside its plain version, its bound and SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(6)
    b, length = LC_BATCH, LC_SEQ
    q, k, v, _ = flash_inputs(b, length, length, gen, dev)
    pairs = length * (length + 1) / 2
    per_product = 2.0 * b * LC_HEADS * pairs * HEAD_DIM
    act = b * length * LC_HEADS * HEAD_DIM * 2
    acc = b * LC_HEADS * length * HEAD_DIM * 4          # f32 [B, H, L, 64]
    row = b * LC_HEADS * length * 4
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    r = dict(flops=2 * per_product, ms=time_ms(lambda: fa.flash_fwd_carry(q, k, v), 10),
             plain_ms=time_ms(lambda: fa.flash_forward_carry_plain(q, k, v), 1),
             library_ms=time_ms(
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10),
             bound=bound(3 * act + acc + 2 * row, 2 * per_product))
    carry = fa.flash_fwd_carry(q, k, v)
    with_carry = time_ms(lambda: fa.flash_fwd_carry(q, k, v, carry), 10)
    log(f"time flash_fwd_carry B={b} L={length} H={LC_HEADS} hd={HEAD_DIM}, no carry in: "
        f"kernel {r['ms']:.3f} ms ({rate(r)}), plain {r['plain_ms']:.3f} ms, library (SDPA, "
        f"no carry merge) {r['library_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
        f"({r['bound'][1]}); "
        f"with a carry in {with_carry:.3f} ms; the forward kernel "
        f"{time_ms(lambda: fa.flash_fwd(q, k, v), 10):.3f} ms in the same run")
    return {"flash_fwd_carry": r}


def sequence_parallel_path(kernels, dev):
    """Phase 8: sequence-parallel training through the port's session, a
    ring of one card."""
    from autodist_tpu_torch import AutoDist, SequenceParallel
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.parallel.sequence import (create_sequence_parallel_session,
                                                      make_sequence_parallel_loss_fn)
    from autodist_tpu_torch.runner import step_function
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=LC_HEADS, n_layers=6,
                                  d_ff=2048, max_len=LC_SEQ, dtype=torch.bfloat16,
                                  remat=True, attention_impl="ring", fused_head=True,
                                  tied_output=False)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    log(f"sequence parallel: {cfg}")

    # Reference on a small input: the ring model vs the flash model, same weights.
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 2, min(1024, LC_SEQ), seed=97).items()}
    flash_model = tlm.TransformerLM(dataclasses.replace(cfg, attention_impl="flash"))
    with torch.no_grad():
        ring = float(make_sequence_parallel_loss_fn(model)(params, small))
        flash = float(tlm.make_loss_fn(flash_model)(params, small))
    log(f"sequence-parallel reference: ring loss {ring:.6f} vs flash loss {flash:.6f}")
    if not (math.isfinite(ring) and abs(ring - flash) <= 1e-2 * abs(flash)):
        raise AssertionError("ring-attention loss disagrees with flash attention")

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=SequenceParallel(seq_axis_size=1), device=dev)
    runner = create_sequence_parallel_session(
        ad, model, params, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    step = step_function(runner, params)
    batch = tlm.synthetic_batch(cfg, LC_BATCH, LC_SEQ)
    log(f"sequence parallel: mesh {dict(runner.plan.mesh_axes)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC_COUNTED, kernels)
    log(f"sequence parallel: losses {losses}; step seconds {times}")
    log(f"sequence parallel: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items() if count == 0 and name != "flash_fwd"]
    if missing or launches["flash_fwd"]:
        raise AssertionError(f"sequence-parallel path: never launched {missing}; "
                             f"flash_fwd launched {launches['flash_fwd']} times")

    tokens = LC_BATCH * LC_SEQ
    torch.cuda.reset_peak_memory_stats()
    float(step(batch))
    t0 = time.perf_counter()
    for _ in range(LC_STEADY):
        loss = step(batch)
    float(loss)
    per_step = (time.perf_counter() - t0) / LC_STEADY
    flops = transformer_flops_per_token(D, 6, 2048, V, LC_SEQ) * tokens
    log(f"sequence parallel: {tokens / per_step:.1f} tokens/s over {LC_STEADY} steady steps "
        f"({tokens} tokens/step, {1e3 * per_step:.3f} ms/step), MFU "
        f"{mfu(flops / per_step):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(step, [batch] * LC_PROFILE, label="sequence-parallel profile")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import _build
    from autodist_tpu_torch.ops import flash_attention as fa
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
    serialized = []
    for name in built:
        for line in ptxas_summary(_build.build_log(name)):
            log(f"ptxas {name}: {line}")
            if all(word in line for word in SERIALIZED_WGMMA):
                serialized.append(line)
    if serialized:
        raise AssertionError(f"ptxas serialized the wgmma of a kernel: {serialized}")
    log(f"flash forward kernels: {fa._lib().flash_fwd_smem_bytes()} bytes of dynamic shared "
        "memory a block")

    errs = check_kernels(fx, dev)
    timing = time_kernels(fx, dev)
    errs.update(check_flash(fa, dev))
    timing.update(time_flash(fa, dev))
    errs.update(check_carry(fa, dev))
    ring_err = check_ring_replay(fa, dev)
    errs["flash_fwd_carry"] = max(errs["flash_fwd_carry"], ring_err)
    timing.update(time_carry(fa, dev))
    # The pack is counted with them (it runs in the forward's and dh's
    # wrappers), but it replaces no TPU kernel and has no row in the JSON line.
    every = fx.KERNELS + fa.KERNELS + (fx.xent_pack_w,)
    by_phase = {"flagship": main_path(every, dev),
                "long_context": long_context_path(every, dev),
                "sequence_parallel": sequence_parallel_path(every, dev)}

    # Each kernel's main path: the flagship for the fused head, the
    # long-context run for flash attention, the sequence-parallel run for
    # the carry. Keyed by the name in the JSON line, with the wrapper's name.
    sites = {
        "xent_fwd": ("xent_fwd", "fused_xent", "autodist_tpu/ops/fused_xent.py:192",
                     "flagship"),
        "xent_dh": ("xent_dh", "fused_xent", "autodist_tpu/ops/fused_xent.py:287", "flagship"),
        "xent_dwdb": ("xent_dwdb", "fused_xent", "autodist_tpu/ops/fused_xent.py:305",
                      "flagship"),
        "flash_fwd": ("flash_fwd", "flash_attention",
                      "autodist_tpu/ops/flash_attention.py:144", "long_context"),
        "flash_bwd_dkdv": ("flash_bwd_dkdv", "flash_attention",
                           "autodist_tpu/ops/flash_attention.py:332", "long_context"),
        "flash_bwd_dq": ("flash_bwd_dq", "flash_attention",
                         "autodist_tpu/ops/flash_attention.py:355", "long_context"),
        "flash_carry": ("flash_fwd_carry", "flash_attention",
                        "autodist_tpu/ops/flash_attention.py:480", "sequence_parallel"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"autodist_tpu_torch/ops/csrc/{src}.cu",
                "replaces": replaces, "launches": by_phase[phase][fn],
                "launches_by_phase": {p: counts[fn] for p, counts in by_phase.items()},
                "max_abs_err": errs[fn], "ms": timing[fn]["ms"],
                "plain_ms": timing[fn]["plain_ms"],
                "bound_ms": timing[fn]["bound"][0],
                "bound_by": timing[fn]["bound"][1],
                "library_ms": timing[fn]["library_ms"],
                "tflops": timing[fn]["tflops"], "bound_share": timing[fn]["bound_share"]}
               for name, (fn, src, replaces, phase) in sites.items()]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
