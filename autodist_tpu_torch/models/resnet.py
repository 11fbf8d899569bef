"""ResNet for ImageNet-class benchmarks (counterpart of
``autodist_tpu/models/resnet.py``): NHWC images, bf16 activations over f32
params, GroupNorm by default (a pure function of the batch), or
``norm="batch"``: :class:`~autodist_tpu_torch.models.layers.SyncBatchNorm`,
whose statistics cover the global batch under data parallelism. Inference
with stored statistics reads a ``bn_ema`` collection outside params, which
:func:`calibrate_bn_ema` produces after training; nothing is threaded
through the train step or the checkpoint.

Parameters keep flax's names and layouts (``conv_init.kernel``
``[7, 7, 3, 64]``, ``stage0_block0.norm1.scale``, ``head.kernel``
``[2048, classes]``), so ``from_jax_params`` carries JAX weights across.
"""

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.common import make_classification_loss_fn, num_groups


@dataclasses.dataclass(frozen=True)
class ResNet50Config:
    num_classes: int = 1000
    stage_sizes: Sequence[int] = (3, 4, 6, 3)      # ResNet-50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    norm_groups: int = 32
    norm: str = "group"          # "group" or "batch" (sync-BN)
    bn_ema: bool = False         # batch norm reads the stored bn_ema statistics


def _make_norm(cfg: ResNet50Config, channels: int) -> nn.Module:
    if cfg.norm == "batch":
        return layers.SyncBatchNorm(channels, dtype=cfg.dtype, use_ema=cfg.bn_ema)
    return layers.GroupNorm(channels, num_groups(channels, cfg.norm_groups), dtype=cfg.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int, cfg: ResNet50Config):
        super().__init__()
        dt = cfg.dtype
        self.conv1 = layers.Conv(in_features, filters, 1, use_bias=False, dtype=dt)
        self.norm1 = _make_norm(cfg, filters)
        self.conv2 = layers.Conv(filters, filters, 3, strides=strides, use_bias=False, dtype=dt)
        self.norm2 = _make_norm(cfg, filters)
        self.conv3 = layers.Conv(filters, filters * 4, 1, use_bias=False, dtype=dt)
        self.norm3 = _make_norm(cfg, filters * 4)
        # flax projects when the residual's shape differs: the first block
        # of every stage (more channels, and stride 2 after stage 0).
        if in_features != filters * 4 or strides != 1:
            self.proj = layers.Conv(in_features, filters * 4, 1, strides=strides,
                                    use_bias=False, dtype=dt)
        else:
            self.proj = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = self.proj(x) if self.proj is not None else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Built on the meta device; apply it with :func:`apply` (or
    ``make_loss_fn``) to NHWC images ``[B, H, W, 3]``."""

    def __init__(self, config: ResNet50Config):
        super().__init__()
        self.config = cfg = config
        if cfg.norm not in ("group", "batch"):
            raise ValueError(f"norm must be 'group' or 'batch', got {cfg.norm!r}")
        self.conv_init = layers.Conv(3, cfg.width, 7, strides=2, use_bias=False,
                                     dtype=cfg.dtype)
        self.norm_init = _make_norm(cfg, cfg.width)
        channels = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                filters = cfg.width * 2 ** stage
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}",
                                BottleneckBlock(channels, filters, strides, cfg))
                channels = filters * 4
        self.head = layers.Dense(channels, cfg.num_classes, dtype=torch.float32)
        layers.name_sites(self)

    def forward(self, images):
        cfg = self.config
        x = layers.nchw(images).to(cfg.dtype)
        x = F.relu(self.norm_init(self.conv_init(x)))
        x = layers.max_pool(x, 3, strides=2, padding="SAME")
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        return self.head(x.mean(dim=(2, 3)))


def apply(model: ResNet, params: Dict[str, torch.Tensor], images,
          bn_ema: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Logits ``[B, classes]`` (f32); ``bn_ema`` is the statistics
    collection an ``bn_ema=True`` model reads."""
    return layers.apply(model, {**params, **(bn_ema or {})}, images)


def calibrate_bn_ema(model: ResNet, params: Dict[str, torch.Tensor],
                     image_batches: Iterable, momentum: float = 0.9
                     ) -> Dict[str, torch.Tensor]:
    """EMA of every SyncBatchNorm site's ``[2, C]`` (mean, var) over
    forward-only passes of a ``norm="batch"`` model in batch-stats mode
    (``resnet.py:140-180``): the ``bn_ema`` collection, keyed
    ``<site>.stats``, that a ``bn_ema=True`` model reads at inference."""
    if model.config.bn_ema:
        raise ValueError("calibrate with a batch-stats model "
                         "(ResNet50Config(bn_ema=False)); the EMA-reading "
                         "model is for inference")
    ema = None
    for images in image_batches:
        with torch.no_grad(), layers.collect_bn_stats() as stats:
            layers.apply(model, params, images)
        stats = {f"{site}.stats": v for site, v in stats.items()}
        if ema is None:
            ema = stats
        else:
            ema = {k: momentum * e + (1.0 - momentum) * stats[k] for k, e in ema.items()}
    if ema is None:
        raise ValueError("calibrate_bn_ema needs at least one batch")
    return ema


def make_loss_fn(model: ResNet) -> Callable:
    return make_classification_loss_fn(model)


def init_params(config: ResNet50Config, seed: int = 0,
                device: Union[str, torch.device, None] = None
                ) -> Tuple[ResNet, Dict[str, torch.Tensor]]:
    model = ResNet(config)
    return model, layers.init_params(model, seed, device)


def synthetic_batch(config: ResNet50Config, batch_size: int, image_size: int = 224,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
        "labels": rng.randint(0, config.num_classes, size=(batch_size,)).astype(np.int32),
    }
