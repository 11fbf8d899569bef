"""DenseNet-121 for ImageNet-class benchmarks (counterpart of
``autodist_tpu/models/densenet.py``): pre-activation norm -> relu -> conv
dense layers whose outputs concatenate onto the channels, transitions that
compress and 2x2 average-pool, GroupNorm throughout, bf16 activations over
f32 params."""

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import make_classification_loss_fn, num_groups


@dataclasses.dataclass(frozen=True)
class DenseNet121Config:
    num_classes: int = 1000
    block_sizes: Sequence[int] = (6, 12, 24, 16)   # DenseNet-121
    growth_rate: int = 32
    init_features: int = 64
    bottleneck_width: int = 4                      # the 1x1 conv emits width * growth
    compression: float = 0.5                       # transition channel reduction
    dtype: torch.dtype = torch.bfloat16
    norm_groups: int = 32


def _norm(channels: int, cfg: DenseNet121Config) -> layers.GroupNorm:
    return layers.GroupNorm(channels, num_groups(channels, cfg.norm_groups), dtype=cfg.dtype)


class DenseLayer(nn.Module):
    """norm -> relu -> 1x1 conv -> norm -> relu -> 3x3 conv, concatenated
    after its input."""

    def __init__(self, in_features: int, cfg: DenseNet121Config):
        super().__init__()
        inter = cfg.bottleneck_width * cfg.growth_rate
        self.norm1 = _norm(in_features, cfg)
        self.conv1 = layers.Conv(in_features, inter, 1, use_bias=False, dtype=cfg.dtype)
        self.norm2 = _norm(inter, cfg)
        self.conv2 = layers.Conv(inter, cfg.growth_rate, 3, use_bias=False, dtype=cfg.dtype)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    """norm -> relu -> 1x1 conv (compression) -> 2x2 average pool."""

    def __init__(self, in_features: int, out_features: int, cfg: DenseNet121Config):
        super().__init__()
        self.norm = _norm(in_features, cfg)
        self.conv = layers.Conv(in_features, out_features, 1, use_bias=False, dtype=cfg.dtype)

    def forward(self, x):
        return layers.avg_pool(self.conv(F.relu(self.norm(x))), 2, strides=2)


class DenseNet(nn.Module):
    def __init__(self, config: DenseNet121Config):
        super().__init__()
        self.config = cfg = config
        self.conv_init = layers.Conv(3, cfg.init_features, 7, strides=2, use_bias=False,
                                     dtype=cfg.dtype)
        self.norm_init = _norm(cfg.init_features, cfg)
        channels = cfg.init_features
        for stage, n_layers in enumerate(cfg.block_sizes):
            for layer in range(n_layers):
                self.add_module(f"block{stage}_layer{layer}", DenseLayer(channels, cfg))
                channels += cfg.growth_rate
            if stage != len(cfg.block_sizes) - 1:
                out = int(channels * cfg.compression)
                self.add_module(f"transition{stage}", Transition(channels, out, cfg))
                channels = out
        self.norm_final = _norm(channels, cfg)
        self.head = layers.Dense(channels, cfg.num_classes, dtype=torch.float32)

    def forward(self, images):
        cfg = self.config
        x = layers.nchw(images).to(cfg.dtype)
        x = F.relu(self.norm_init(self.conv_init(x)))
        x = layers.max_pool(x, 3, strides=2, padding="SAME")
        for stage, n_layers in enumerate(cfg.block_sizes):
            for layer in range(n_layers):
                x = getattr(self, f"block{stage}_layer{layer}")(x)
            if stage != len(cfg.block_sizes) - 1:
                x = getattr(self, f"transition{stage}")(x)
        x = F.relu(self.norm_final(x))
        return self.head(x.mean(dim=(2, 3)))


def make_loss_fn(model: DenseNet) -> Callable:
    return make_classification_loss_fn(model)


def init_params(config: DenseNet121Config, seed: int = 0, device=None
                ) -> Tuple[DenseNet, Dict[str, torch.Tensor]]:
    model = DenseNet(config)
    return model, layers.init_params(model, seed, device)


def synthetic_batch(config: DenseNet121Config, batch_size: int, image_size: int = 224,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
        "labels": rng.randint(0, config.num_classes, size=(batch_size,)).astype(np.int32),
    }
