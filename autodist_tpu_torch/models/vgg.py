"""VGG-16, the dense-parameter-heavy benchmark model (counterpart of
``autodist_tpu/models/vgg.py``): 13 "SAME" 3x3 convs with biases in five
stages, each closed by a 2x2 max pool, then fc1, fc2 (4,096) and the f32
head. The first dense layer reads the NHWC flattening, so its kernel's rows
are flax's; its input width depends on the image size, which the module
therefore takes."""

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import make_classification_loss_fn

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        channels, size = 3, image_size
        for stage, (filters, convs) in enumerate(STAGES):
            for c in range(convs):
                self.add_module(f"conv{stage}_{c}",
                                layers.Conv(channels, filters, 3, dtype=dtype))
                channels = filters
            size //= 2
        self.fc1 = layers.Dense(channels * size * size, 4096, dtype=dtype)
        self.fc2 = layers.Dense(4096, 4096, dtype=dtype)
        self.head = layers.Dense(4096, num_classes, dtype=torch.float32)

    def forward(self, images):
        x = layers.nchw(images).to(self.dtype)
        for stage, (_, convs) in enumerate(STAGES):
            for c in range(convs):
                x = F.relu(getattr(self, f"conv{stage}_{c}")(x))
            x = layers.max_pool(x, 2, strides=2)
        x = layers.flatten_nhwc(x)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.head(x)


def make_loss_fn(model: VGG16) -> Callable:
    return make_classification_loss_fn(model)


def init_params(model: VGG16, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    return layers.init_params(model, seed, device)


def synthetic_batch(num_classes: int, batch_size: int, image_size: int = 224,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
        "labels": rng.randint(0, num_classes, size=(batch_size,)).astype(np.int32),
    }
