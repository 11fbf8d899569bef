"""Image classifier, the three-step API demo (the port's counterpart of
``examples/image_classifier.py``): a small CNN on synthetic 28 x 28 images,
trained under ``PSLoadBalancing`` and fed by the native ``DataLoader``
(shuffled, drop-last) through ``device_prefetch``, so batch assembly and the
copy to the card overlap the step.

    python -m autodist_tpu_torch.examples.image_classifier            # the card
    python -m autodist_tpu_torch.examples.image_classifier --device cpu
"""

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch import AutoDist, PSLoadBalancing
from autodist_tpu_torch.data.loader import DataLoader, device_prefetch
from autodist_tpu_torch.models import layers


class SmallCNN(nn.Module):
    """conv 3x3 (32) -> 2x2 max pool -> conv 3x3 (64) -> 2x2 max pool ->
    dense 128 -> dense head, f32, flax's names and layouts."""

    def __init__(self, num_classes: int = 10, image_size: int = 28, channels: int = 1):
        super().__init__()
        self.conv1 = layers.Conv(channels, 32, 3)
        self.conv2 = layers.Conv(32, 64, 3)
        side = image_size // 2 // 2
        self.fc = layers.Dense(64 * side * side, 128)
        self.head = layers.Dense(128, num_classes)

    def forward(self, images):
        x = layers.max_pool(F.relu(self.conv1(layers.nchw(images))), 2, strides=2)
        x = layers.max_pool(F.relu(self.conv2(x)), 2, strides=2)
        x = F.relu(self.fc(layers.flatten_nhwc(x)))
        return self.head(x)


def main(epochs: int = 5, batch_size: int = 64, device=None) -> List[float]:
    rng = np.random.RandomState(0)
    images = rng.randn(512, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, size=(512,)).astype(np.int32)

    # Step 1: the model and its loss.
    ad = AutoDist(strategy_builder=PSLoadBalancing(), device=device)
    model = SmallCNN()
    params = layers.init_params(model, seed=0, device="cpu")

    def loss_fn(p, batch):
        logits = layers.apply(model, p, batch["images"])
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, batch["labels"].long()[:, None]).mean()

    # Step 2: the distributed step function.
    step = ad.function(loss_fn, params, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                       example_batch={"images": images[:8], "labels": labels[:8]})

    # Step 3: train, fed by the native loader two batches ahead on the device.
    loader = DataLoader({"images": images, "labels": labels},
                        batch_size=batch_size, shuffle=True, seed=0)
    feed = device_prefetch(loader, step.runner, depth=2)
    steps_per_epoch = len(images) // batch_size
    losses = []
    try:
        for epoch in range(epochs):
            for _ in range(steps_per_epoch):
                loss = step(next(feed))
            losses.append(float(loss))
            print(f"epoch {epoch}: loss={losses[-1]:.4f} "
                  f"(loader={'native' if loader.is_native else 'numpy'})")
    finally:
        feed.close()     # stop the producer before its loader goes away
        loader.close()
    assert losses[-1] < losses[0]
    return losses


def cli(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(device=parser.parse_args(argv).device)


if __name__ == "__main__":
    cli()
