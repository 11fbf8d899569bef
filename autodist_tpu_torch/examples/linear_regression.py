"""Linear regression, the minimum slice (the port's counterpart of
``examples/linear_regression.py``): a two-parameter model trained for 10
full-batch SGD steps under ``AllReduce``, the loss falling.

    python -m autodist_tpu_torch.examples.linear_regression            # the card
    python -m autodist_tpu_torch.examples.linear_regression --device cpu
"""

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch import AllReduce, AutoDist

TRUE_W, TRUE_B = 3.0, 2.0
NUM_EXAMPLES = 1024


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(NUM_EXAMPLES).astype(np.float32)
    noise = rng.randn(NUM_EXAMPLES).astype(np.float32)
    y = x * TRUE_W + TRUE_B + noise
    return x, y


def loss_fn(p, batch):
    pred = batch["x"] * p["w"] + p["b"]
    return ((batch["y"] - pred) ** 2).mean()


def main(device=None) -> List[float]:
    x, y = make_data()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    params = {"w": torch.zeros(()), "b": torch.zeros(())}
    step = ad.function(loss_fn, params, lambda p: torch.optim.SGD(p, lr=0.05),
                       example_batch={"x": x[:8], "y": y[:8]})

    losses = []
    for epoch in range(10):
        loss = step({"x": x, "y": y})
        losses.append(float(loss))
        print(f"step {epoch}: loss={losses[-1]:.4f}")

    final = step.get_state().params
    print(f"w={final['w'].item():.3f} (true {TRUE_W}), b={final['b'].item():.3f} "
          f"(true {TRUE_B})")
    assert losses[-1] < losses[0], "loss must decrease"
    return losses


def cli(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(parser.parse_args(argv).device)


if __name__ == "__main__":
    cli()
