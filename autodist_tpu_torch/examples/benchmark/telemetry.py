"""The telemetry planes' cost around the flagship's ``train()``: tokens/s
with every plane off, every plane armed as a user arms them
(``AUTODIST_TELEMETRY``, ``AUTODIST_PROFILE``, ``AUTODIST_HEALTH``,
``AUTODIST_METRICS_DIR``, ``AUTODIST_METRICS_PORT`` on a loopback exporter,
``AUTODIST_RECORDER``), health alone, every plane but health, and the
spans alone (``AUTODIST_TELEMETRY``: the per-dispatch spans and signature
hash, and at each log boundary the memory sample and the metric line), in
turns and then in the reverse order; then a ``torch.profiler`` window over
two steps, and the same turns again (a profiler session leaves the
process's later runs slower, so phase 20 of ``chip_smoke.py``, which runs
after the profiled phases, reads its cost in the second regime). Last, the
host time of one step's armed spans (the runner's dispatch span with its
signature hash, and ``train()``'s three), timed alone. One line a run,
then one JSON line of the means by plane and regime. ``--planes`` and
``--regimes first`` cut the turns; a larger ``--log_every`` (a real run
logs every 100 steps) leaves the boundary planes' share out.

On the card the flagship d512 x 6 at vocab 32,000, micro 64 x seq 256 x
accum 2, its batches carrying an all-ones float ``mask`` (phase 20 uses
this shape and these helpers); on the host pass a tiny model.

    python -m autodist_tpu_torch.examples.benchmark.telemetry
    python -m autodist_tpu_torch.examples.benchmark.telemetry --device cpu --d_model 64 \\
        --n_layers 1 --vocab 128 --micro_batch 4 --seq_len 16 --steps 9
    python -m autodist_tpu_torch.examples.benchmark.telemetry --micro_batch 384 --accum 8 \\
        --planes off,all --regimes first --steps 9
"""

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AllReduce, AutoDist, telemetry
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.telemetry import history, openmetrics, profiling, recorder
from autodist_tpu_torch.training import train
from autodist_tpu_torch.utils.device import resolve_device

PLANES = ("off", "all", "health", "planes_no_health", "spans")
SPAN_REPS = 20_000


def config(vocab: int = 32000, d_model: int = 512, n_layers: int = 6) -> tlm.TransformerLMConfig:
    """The flagship's configuration (``bench.py``'s widths by default)."""
    return tlm.TransformerLMConfig(vocab_size=vocab, d_model=d_model, n_heads=8,
                                   n_layers=n_layers, d_ff=4 * d_model, max_len=512,
                                   fused_head=True, tied_output=False, dtype=torch.bfloat16)


def make_batch(cfg, i: int, rows: int, seq_len: int, poison: bool = False) -> dict:
    """Step ``i``'s synthetic batch with an all-ones float ``mask`` (the
    loss's masked mean, the same loss), so the fault harness's ``nan_grads``
    and a poisoned batch (``poison``: a NaN mask) have floats to NaN."""
    batch = tlm.synthetic_batch(cfg, rows, seq_len, seed=2000 + i)
    batch["mask"] = np.full(batch["tokens"].shape, np.nan if poison else 1.0, np.float32)
    return batch


def session(model, params, device, accum: int, health: Optional[bool] = None):
    """The flagship's runner under ``AllReduce`` and Adam on one device."""
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce(), device=device)
    return ad.create_distributed_session(tlm.make_loss_fn(model), params,
                                         lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                                         accumulation_steps=accum, health=health)


def armed_env(tmp: str, exporter_port: int) -> dict:
    """Every plane's flag, as a user arms them, writing under ``tmp``."""
    return {"AUTODIST_TELEMETRY": "1", "AUTODIST_PROFILE": "1", "AUTODIST_HEALTH": "1",
            "AUTODIST_PROFILE_DIR": os.path.join(tmp, "profiles"),
            "AUTODIST_METRICS_DIR": os.path.join(tmp, "metrics"),
            "AUTODIST_METRICS_PORT": str(exporter_port),
            "AUTODIST_RECORDER": "1", "AUTODIST_RECORDER_DIR": os.path.join(tmp, "flightrec")}


class Planes:
    """Arm the planes ``env`` names for a block (``env=None``: none): the
    flags in the environment, and what ``AUTODIST_TELEMETRY`` and
    ``AUTODIST_PROFILE`` do at import (the modules are imported already)
    done by hand. On exit the environment, the history, the recorder, spans
    and profiling are as before."""

    def __init__(self, env: Optional[dict]):
        self.env = env or {}

    def __enter__(self):
        before = dict(os.environ)
        self.saved = {k: before.get(k) for k in self.env}
        os.environ.update(self.env)
        history.set_history(None)
        if self.env.get("AUTODIST_TELEMETRY"):
            telemetry.enable()
        if self.env.get("AUTODIST_PROFILE"):
            profiling.enable()
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        history.set_history(None)
        recorder.set_recorder(None)
        profiling.disable()
        telemetry.disable()


def train_rates(runner, params, batches, steps: int, seq_len: int, **kw):
    """``train()``; ``(final state, tokens/s of each log period)``."""
    rates = []
    state = train(runner, params, batches, steps=steps,
                  on_metrics=lambda step, loss, rate: rates.append(seq_len * rate), **kw)
    return state, rates


def mean_after_first(rates) -> float:
    """The mean rate of the periods after the first (the build's)."""
    return sum(rates[1:]) / max(1, len(rates) - 1)


def armed_spans_us(runner, batch, reps: int = SPAN_REPS) -> float:
    """Host microseconds of one step's spans with ``AUTODIST_TELEMETRY`` on:
    the runner's dispatch span (the signature string, its crc32, the
    dispatch count) and ``train()``'s ``train.data_wait``,
    ``train.dispatch`` and ``runner.shard_batch``, on a built signature."""
    sharded = runner.shard_batch(batch)
    telemetry.enable()
    try:
        with runner._dispatch_span("runner.run.dispatch", "step", None, sharded):
            pass
        t0 = time.perf_counter()
        for _ in range(reps):
            with telemetry.span("train.data_wait"):
                pass
            with telemetry.span("train.dispatch"):
                with telemetry.span("runner.shard_batch"):
                    pass
                with runner._dispatch_span("runner.run.dispatch", "step", None, sharded):
                    pass
        return 1e6 * (time.perf_counter() - t0) / reps
    finally:
        telemetry.disable()
        telemetry.clear()
        profiling.reset()


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' for the host)")
    parser.add_argument("--micro_batch", type=int, default=64)
    parser.add_argument("--accum", type=int, default=2)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=6)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--steps", type=int, default=21,
                        help="steps a run (periods of --log_every after a one-step warm-up)")
    parser.add_argument("--log_every", type=int, default=4)
    parser.add_argument("--planes", default=",".join(PLANES),
                        help=f"comma-separated planes to turn through, of {PLANES}")
    parser.add_argument("--regimes", choices=("both", "first"), default="both",
                        help="'first': no profiler window, the first regime only")
    args = parser.parse_args(argv)
    args.planes = tuple(args.planes.split(","))
    if not set(args.planes) <= set(PLANES):
        parser.error(f"--planes: not in {PLANES}: {args.planes}")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config(args.vocab, args.d_model, args.n_layers)
    model, params = tlm.init_params(cfg, seed=0, device=device)
    rows = args.micro_batch * args.accum

    def batches(i):
        return make_batch(cfg, i, rows, args.seq_len)

    exporter = openmetrics.MetricsExporter(port=0, host="127.0.0.1")
    openmetrics.set_exporter(exporter)
    means = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            armed = armed_env(tmp, exporter.address[1])
            envs = {"off": None, "all": armed, "health": {"AUTODIST_HEALTH": "1"},
                    "planes_no_health": {k: v for k, v in armed.items()
                                         if k != "AUTODIST_HEALTH"},
                    "spans": {"AUTODIST_TELEMETRY": "1"}}
            regimes = ("no profiler yet", "after a profiler window")
            for regime in regimes[:1] if args.regimes == "first" else regimes:
                if regime != "no profiler yet":
                    runner = session(model, params, device, args.accum)
                    state = runner.init(params)
                    with torch.profiler.profile():
                        for i in range(2):
                            runner.run(state, batches(i))
                    del runner, state
                for plane in args.planes + args.planes[::-1]:
                    with Planes(envs[plane]):
                        runner = session(model, params, device, args.accum)
                        _, rates = train_rates(runner, params, batches, args.steps,
                                               args.seq_len, log_every=args.log_every)
                    rate = mean_after_first(rates)
                    means.setdefault(regime, {}).setdefault(plane, []).append(rate)
                    print(f"{regime}, {plane}: {rate:.1f} tokens/s after the first period "
                          f"({[round(r, 1) for r in rates]})", flush=True)
                    del runner
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
        runner = session(model, params, device, args.accum)
        span_us = armed_spans_us(runner, batches(0))
        del runner
    finally:
        openmetrics.set_exporter(None)
    result = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "tokens_per_step": rows * args.seq_len, "log_every": args.log_every,
              "armed_spans_us_per_step": span_us,
              "tokens_per_s": {regime: {plane: sum(v) / len(v) for plane, v in by.items()}
                               for regime, by in means.items()}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
