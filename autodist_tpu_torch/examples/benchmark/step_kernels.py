"""Device kernels and busy ms a step of the flagship's ``run()`` with every
telemetry plane off, for whichever ``autodist_tpu_torch`` is importable: run
it as a file with ``PYTHONPATH`` naming a checkout, so one call can hold two
versions of the package against each other on one card, in turns. It uses
only the API every version since the flagship's port has (``AutoDist``,
``create_distributed_session``, ``run``). One JSON line. Phase 20 of
``chip_smoke.py`` counts a step's kernels with :func:`kernels_a_step`.

    PYTHONPATH=. python3 autodist_tpu_torch/examples/benchmark/step_kernels.py this
    PYTHONPATH=OTHER python3 autodist_tpu_torch/examples/benchmark/step_kernels.py other

The flagship d512 x 6, vocab 32,000, at micro 64 x seq 256 x accum 2 (128
rows a step, no mask), two warm-up steps, then a ``torch.profiler`` window
over four after one more in its warm-up (kernels a step, the profiler's own
annotations left out).
"""

import collections
import json
import os
import sys
import time

import torch

import autodist_tpu_torch
from autodist_tpu_torch import AllReduce, AutoDist
from autodist_tpu_torch.models import transformer_lm as tlm


def kernels_a_step(runner, state, batches):
    """A ``torch.profiler`` window over one ``run()`` a batch of
    ``batches[1:]``, after one on ``batches[0]`` in its warm-up (the
    profiler's first launches can go unrecorded while it starts): ``(device
    kernels a step, busy ms a step (the union of their intervals), the
    window's kernels by name, its wall ms a step)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    n = len(batches) - 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
        for i, b in enumerate(batches):
            runner.run(state, b)
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            elif i == n:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return (len(kernels) / n, busy / n / 1e3, collections.Counter(e.name for e in kernels),
            1e3 * wall / n)


def main(label: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("step_kernels: the card's kernels need a CUDA device")
    dev = torch.device("cuda:0")
    cfg = tlm.TransformerLMConfig(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                                  d_ff=2048, max_len=512, fused_head=True, tied_output=False,
                                  dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce(), device=dev)
    runner = ad.create_distributed_session(tlm.make_loss_fn(model), params,
                                           lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                                           accumulation_steps=2)
    state = runner.init(params)
    batches = [tlm.synthetic_batch(cfg, 128, 256, seed=i) for i in range(7)]
    for b in batches[:2]:
        runner.run(state, b)
    per_step, busy_ms, names, wall_ms = kernels_a_step(runner, state, batches[2:])
    result = {"label": label, "package": os.path.dirname(autodist_tpu_torch.__file__),
              "device": torch.cuda.get_device_name(dev),
              "kernels_per_step": per_step, "busy_ms_per_step": busy_ms,
              "distinct_kernels": len(names), "wall_ms_per_step_profiled": wall_ms}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "this")
