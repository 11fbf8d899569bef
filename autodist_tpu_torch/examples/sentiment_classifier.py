"""Sentiment classifier, the sparse-gradient demo (the port's counterpart of
``examples/sentiment_classifier.py``): a bag-of-embeddings classifier whose
loss gathers ``batch["tokens"]`` from a 10,000 x 64 table. Given only
``example_batch``, the sparse-parameter walk finds the table sparse with
the index leaf ``tokens``, so ``Parallax`` routes it to a PS synchronizer
(across ranks its gradient travels as (indices, rows)) while the dense
head's gradient is all-reduced.

    python -m autodist_tpu_torch.examples.sentiment_classifier            # the card
    python -m autodist_tpu_torch.examples.sentiment_classifier --device cpu
"""

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import AutoDist, Parallax

VOCAB = 10_000
DIM = 64
SEQ = 32


def loss_fn(p, batch):
    emb = p["embedding"][batch["tokens"].long()]                  # [B, S, D]
    pooled = emb.mean(dim=1)
    logits = (pooled @ p["w"] + p["b"])[:, 0]
    labels = batch["labels"].float()
    return (F.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()


def main(steps: int = 30, batch_size: int = 64, device=None) -> List[float]:
    rng = np.random.RandomState(0)
    params = {
        "embedding": torch.tensor(rng.randn(VOCAB, DIM) * 0.1, dtype=torch.float32),
        "w": torch.tensor(rng.randn(DIM, 1) * 0.1, dtype=torch.float32),
        "b": torch.zeros((1,)),
    }
    tokens = rng.randint(0, VOCAB, size=(512, SEQ)).astype(np.int32)
    labels = rng.randint(0, 2, size=(512,)).astype(np.int32)

    ad = AutoDist(strategy_builder=Parallax(), device=device)
    step = ad.function(loss_fn, params, lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                       example_batch={"tokens": tokens[:8], "labels": labels[:8]})

    losses = []
    for i in range(steps):
        sl = slice((i * batch_size) % 512, (i * batch_size) % 512 + batch_size)
        losses.append(float(step({"tokens": tokens[sl], "labels": labels[sl]})))
        if i % 10 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")

    kinds = {n.var_name: n.which_synchronizer() for n in ad._strategy.node_config}
    print("routing:", kinds)
    assert kinds["embedding"] == "ps_synchronizer", "sparse table should go to PS"
    assert losses[-1] < losses[0]
    return losses


def cli(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(device=parser.parse_args(argv).device)


if __name__ == "__main__":
    cli()
