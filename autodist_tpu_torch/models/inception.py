"""Inception-V3 for ImageNet-class benchmarks (counterpart of
``autodist_tpu/models/inception.py``): conv -> GroupNorm -> relu cells in
the paper's branch structure (blocks A, B, C, D, E; no auxiliary head),
bf16 activations over f32 params. ``repeats`` sets how many A, C and E
blocks there are; B and D always are. The 3x3/1 "SAME" average pools count
their padded zeros, as flax's do."""

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import make_classification_loss_fn, num_groups


@dataclasses.dataclass(frozen=True)
class InceptionV3Config:
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    norm_groups: int = 32
    repeats: Tuple[int, int, int] = (3, 4, 2)     # A, C, E blocks: the paper's V3


class ConvNorm(nn.Module):
    """conv -> GroupNorm -> relu, the basic Inception cell."""

    def __init__(self, cfg: InceptionV3Config, in_features: int, features: int, kernel,
                 strides=1, padding: str = "SAME"):
        super().__init__()
        self.conv = layers.Conv(in_features, features, kernel, strides=strides,
                                padding=padding, use_bias=False, dtype=cfg.dtype)
        self.norm = layers.GroupNorm(features, num_groups(features, cfg.norm_groups),
                                     dtype=cfg.dtype)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


def _pool_branch(x):
    return layers.avg_pool(x, 3, strides=1, padding="SAME")


class InceptionA(nn.Module):
    def __init__(self, cfg, c: int, pool_features: int):
        super().__init__()
        self.b1_1x1 = ConvNorm(cfg, c, 64, 1)
        self.b2_1x1 = ConvNorm(cfg, c, 48, 1)
        self.b2_5x5 = ConvNorm(cfg, 48, 64, 5)
        self.b3_1x1 = ConvNorm(cfg, c, 64, 1)
        self.b3_3x3a = ConvNorm(cfg, 64, 96, 3)
        self.b3_3x3b = ConvNorm(cfg, 96, 96, 3)
        self.b4_pool = ConvNorm(cfg, c, pool_features, 1)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.b1_1x1(x)
        b2 = self.b2_5x5(self.b2_1x1(x))
        b3 = self.b3_3x3b(self.b3_3x3a(self.b3_1x1(x)))
        b4 = self.b4_pool(_pool_branch(x))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionB(nn.Module):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, cfg, c: int):
        super().__init__()
        self.b1_3x3 = ConvNorm(cfg, c, 384, 3, strides=2, padding="VALID")
        self.b2_1x1 = ConvNorm(cfg, c, 64, 1)
        self.b2_3x3a = ConvNorm(cfg, 64, 96, 3)
        self.b2_3x3b = ConvNorm(cfg, 96, 96, 3, strides=2, padding="VALID")
        self.out_features = 384 + 96 + c

    def forward(self, x):
        b1 = self.b1_3x3(x)
        b2 = self.b2_3x3b(self.b2_3x3a(self.b2_1x1(x)))
        b3 = layers.max_pool(x, 3, strides=2, padding="VALID")
        return torch.cat([b1, b2, b3], dim=1)


class InceptionC(nn.Module):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, cfg, c: int, c7: int):
        super().__init__()
        self.b1_1x1 = ConvNorm(cfg, c, 192, 1)
        self.b2_1x1 = ConvNorm(cfg, c, c7, 1)
        self.b2_1x7 = ConvNorm(cfg, c7, c7, (1, 7))
        self.b2_7x1 = ConvNorm(cfg, c7, 192, (7, 1))
        self.b3_1x1 = ConvNorm(cfg, c, c7, 1)
        self.b3_7x1a = ConvNorm(cfg, c7, c7, (7, 1))
        self.b3_1x7a = ConvNorm(cfg, c7, c7, (1, 7))
        self.b3_7x1b = ConvNorm(cfg, c7, c7, (7, 1))
        self.b3_1x7b = ConvNorm(cfg, c7, 192, (1, 7))
        self.b4_pool = ConvNorm(cfg, c, 192, 1)
        self.out_features = 4 * 192

    def forward(self, x):
        b1 = self.b1_1x1(x)
        b2 = self.b2_7x1(self.b2_1x7(self.b2_1x1(x)))
        b3 = self.b3_1x1(x)
        for name in ("b3_7x1a", "b3_1x7a", "b3_7x1b", "b3_1x7b"):
            b3 = getattr(self, name)(b3)
        b4 = self.b4_pool(_pool_branch(x))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionD(nn.Module):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, cfg, c: int):
        super().__init__()
        self.b1_1x1 = ConvNorm(cfg, c, 192, 1)
        self.b1_3x3 = ConvNorm(cfg, 192, 320, 3, strides=2, padding="VALID")
        self.b2_1x1 = ConvNorm(cfg, c, 192, 1)
        self.b2_1x7 = ConvNorm(cfg, 192, 192, (1, 7))
        self.b2_7x1 = ConvNorm(cfg, 192, 192, (7, 1))
        self.b2_3x3 = ConvNorm(cfg, 192, 192, 3, strides=2, padding="VALID")
        self.out_features = 320 + 192 + c

    def forward(self, x):
        b1 = self.b1_3x3(self.b1_1x1(x))
        b2 = self.b2_3x3(self.b2_7x1(self.b2_1x7(self.b2_1x1(x))))
        b3 = layers.max_pool(x, 3, strides=2, padding="VALID")
        return torch.cat([b1, b2, b3], dim=1)


class InceptionE(nn.Module):
    """Expanded filter banks at 8x8."""

    def __init__(self, cfg, c: int):
        super().__init__()
        self.b1_1x1 = ConvNorm(cfg, c, 320, 1)
        self.b2_1x1 = ConvNorm(cfg, c, 384, 1)
        self.b2_1x3 = ConvNorm(cfg, 384, 384, (1, 3))
        self.b2_3x1 = ConvNorm(cfg, 384, 384, (3, 1))
        self.b3_1x1 = ConvNorm(cfg, c, 448, 1)
        self.b3_3x3 = ConvNorm(cfg, 448, 384, 3)
        self.b3_1x3 = ConvNorm(cfg, 384, 384, (1, 3))
        self.b3_3x1 = ConvNorm(cfg, 384, 384, (3, 1))
        self.b4_pool = ConvNorm(cfg, c, 192, 1)
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.b1_1x1(x)
        b2 = self.b2_1x1(x)
        b2 = torch.cat([self.b2_1x3(b2), self.b2_3x1(b2)], dim=1)
        b3 = self.b3_3x3(self.b3_1x1(x))
        b3 = torch.cat([self.b3_1x3(b3), self.b3_3x1(b3)], dim=1)
        b4 = self.b4_pool(_pool_branch(x))
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, config: InceptionV3Config):
        super().__init__()
        self.config = cfg = config
        # Stem: 299x299x3 -> 35x35x192.
        self.stem_conv1 = ConvNorm(cfg, 3, 32, 3, strides=2, padding="VALID")
        self.stem_conv2 = ConvNorm(cfg, 32, 32, 3, padding="VALID")
        self.stem_conv3 = ConvNorm(cfg, 32, 64, 3)
        self.stem_conv4 = ConvNorm(cfg, 64, 80, 1)
        self.stem_conv5 = ConvNorm(cfg, 80, 192, 3, padding="VALID")
        n_a, n_c, n_e = cfg.repeats
        blocks, c = [], 192
        for i in range(n_a):
            blocks.append(InceptionA(cfg, c, (32, 64, 64)[min(i, 2)]))
            c = blocks[-1].out_features
        blocks.append(InceptionB(cfg, c))
        c = blocks[-1].out_features
        for i in range(n_c):
            blocks.append(InceptionC(cfg, c, (128, 160, 160, 192)[min(i, 3)]))
            c = blocks[-1].out_features
        blocks.append(InceptionD(cfg, c))
        c = blocks[-1].out_features
        for _ in range(n_e):
            blocks.append(InceptionE(cfg, c))
            c = blocks[-1].out_features
        self.n_blocks = len(blocks)
        for idx, block in enumerate(blocks):
            self.add_module(f"mixed{idx}", block)
        self.head = layers.Dense(c, cfg.num_classes, dtype=torch.float32)

    def forward(self, images):
        x = layers.nchw(images).to(self.config.dtype)
        x = self.stem_conv3(self.stem_conv2(self.stem_conv1(x)))
        x = layers.max_pool(x, 3, strides=2, padding="VALID")
        x = self.stem_conv5(self.stem_conv4(x))
        x = layers.max_pool(x, 3, strides=2, padding="VALID")
        for idx in range(self.n_blocks):
            x = getattr(self, f"mixed{idx}")(x)
        return self.head(x.mean(dim=(2, 3)))


def make_loss_fn(model: InceptionV3) -> Callable:
    return make_classification_loss_fn(model)


def init_params(config: InceptionV3Config, seed: int = 0, device=None
                ) -> Tuple[InceptionV3, Dict[str, torch.Tensor]]:
    model = InceptionV3(config)
    return model, layers.init_params(model, seed, device)


def synthetic_batch(config: InceptionV3Config, batch_size: int, image_size: int = 299,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
        "labels": rng.randint(0, config.num_classes, size=(batch_size,)).astype(np.int32),
    }
