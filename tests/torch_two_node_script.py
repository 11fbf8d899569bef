"""A synchronous run from a two-node loopback resource spec, for
``tests/test_torch_cluster.py``: the chief's ``AutoDist`` launches this
script again as the worker (the Coordinator), both join one gloo group at
the coordinator's address and train a linear model 3 steps under
``AllReduce``; each prints one JSON line (rank, world, losses, params).
Torch and the port only."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import AllReduce, AutoDist, const

SPEC = {"nodes": [{"address": "localhost", "gpus": [0], "chief": True},
                  {"address": "127.0.0.1", "gpus": [0]}]}


def batch():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True).astype(np.float32)}


def loss_fn(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()


def main():
    ad = AutoDist(resource_info=SPEC, strategy_builder=AllReduce(), device="cpu")
    step = ad.function(loss_fn, {"w": torch.zeros(4, 1)}, lambda p: torch.optim.SGD(p, lr=0.1))
    losses = [float(step(batch())) for _ in range(3)]
    # One write of the whole line: both ranks share the pipe, and print()'s
    # separate write of the newline lets the other rank's line land between.
    sys.stdout.write(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                                 "losses": losses,
                                 "w": step.get_state().params["w"].flatten().tolist()}) + "\n")
    sys.stdout.flush()
    if not const.is_worker() and not ad._coordinator.join(timeout=60.0):
        sys.exit("the worker process did not finish")


if __name__ == "__main__":
    main()
