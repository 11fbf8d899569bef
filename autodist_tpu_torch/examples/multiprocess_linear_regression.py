"""Multi-process linear regression: the two-process minimum slice (the
port's counterpart of ``examples/multiprocess_linear_regression.py``).

One process per device under torchrun, which the JAX package's coordinator
and ``jax.distributed`` stand for: gloo on the host, NCCL on the cards. Both
processes join one group through ``create_distributed_session``, build the
2-device mesh and run 3 SGD steps of the minimum slice under ``AllReduce``,
each on its half of every batch; rank 0 writes the final params and losses
to the JSON path given.

    torchrun --standalone --nproc_per_node 2 \\
        -m autodist_tpu_torch.examples.multiprocess_linear_regression out.json
    torchrun --standalone --nproc_per_node 2 \\
        -m autodist_tpu_torch.examples.multiprocess_linear_regression out.json --device cpu
"""

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import AllReduce, AutoDist

BATCH = 16
LR = 0.1
STEPS = 3


def make_batch(step: int):
    rng = np.random.RandomState(1000 + step)
    x = rng.randn(BATCH).astype(np.float32)
    y = (3.0 * x + 2.0 + 0.1 * rng.randn(BATCH)).astype(np.float32)
    return {"x": x, "y": y}


def loss_fn(p, b):
    pred = b["x"] * p["w"] + p["b"]
    return ((b["y"] - pred) ** 2).mean()


def main(out_path: str, device=None) -> Optional[dict]:
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    params = {"w": torch.zeros(()), "b": torch.zeros(())}
    runner = ad.create_distributed_session(
        loss_fn, params, lambda p: torch.optim.SGD(p, lr=LR), example_batch=make_batch(0))
    # The session must have joined both processes into one group.
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world == 2, f"world size {world}"
    assert runner.plan.num_devices == 2, f"device_count={runner.plan.num_devices}"

    state = runner.init(params)
    losses = []
    for step in range(STEPS):
        state, loss = runner.run(state, make_batch(step))
        losses.append(float(loss))

    if dist.get_rank() == 0:
        result = {"w": state.params["w"].item(), "b": state.params["b"].item(),
                  "losses": losses, "process_count": world,
                  "device_count": runner.plan.num_devices}
        with open(out_path, "w") as f:
            json.dump(result, f)
        return result
    return None


def cli(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_path")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK)")
    args = parser.parse_args(argv)
    main(args.out_path, args.device)


if __name__ == "__main__":
    cli()
