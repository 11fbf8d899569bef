"""NeuMF recommender, the sparse-gradient-heavy benchmark (counterpart of
``autodist_tpu/models/ncf.py``): two embedding pairs (GMF and MLP towers)
whose gradients are row-sparse, so ``Parallax`` sends the tables to PS.

Built on the ``meta`` device and applied to a flat params dict
(:func:`apply`); names and layouts are the flax tree's
(``mf_user_embed.embedding`` ``[users, mf_dim]``, ``mlp_0.kernel``
``[in, out]``, ``head.kernel`` ``[mf_dim + mlp_dims[-1], 1]``). The MLP
tower reads ``[mlp_user, mlp_item]``, the head ``[gmf, mlp]``, and the head
computes in f32 whatever the compute dtype.
"""

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models import layers
from autodist_tpu_torch.models.transformer_lm import Embed


@dataclasses.dataclass(frozen=True)
class NeuMFConfig:
    num_users: int = 138_000
    num_items: int = 27_000
    mf_dim: int = 64
    mlp_dims: Sequence[int] = (256, 128, 64)
    dtype: torch.dtype = torch.float32


class NeuMF(nn.Module):
    def __init__(self, config: NeuMFConfig):
        super().__init__()
        self.config = cfg = config
        half = cfg.mlp_dims[0] // 2
        self.mf_user_embed = Embed(cfg.num_users, cfg.mf_dim, cfg.dtype)
        self.mf_item_embed = Embed(cfg.num_items, cfg.mf_dim, cfg.dtype)
        self.mlp_user_embed = Embed(cfg.num_users, half, cfg.dtype)
        self.mlp_item_embed = Embed(cfg.num_items, half, cfg.dtype)
        width = 2 * half
        for i, d in enumerate(cfg.mlp_dims[1:]):
            self.add_module(f"mlp_{i}", layers.Dense(width, d, dtype=cfg.dtype))
            width = d
        self.head = layers.Dense(cfg.mf_dim + width, 1, dtype=torch.float32)

    def forward(self, users, items):
        """int ``[B]`` users and items -> f32 logits ``[B]``."""
        users, items = users.long(), items.long()
        gmf = self.mf_user_embed(users) * self.mf_item_embed(items)
        x = torch.cat([self.mlp_user_embed(users), self.mlp_item_embed(items)], dim=-1)
        for i in range(len(self.config.mlp_dims) - 1):
            x = F.relu(getattr(self, f"mlp_{i}")(x))
        return self.head(torch.cat([gmf, x], dim=-1))[..., 0]


def apply(model: NeuMF, params: Dict[str, torch.Tensor], users, items):
    """``model(users, items)`` with ``params``."""
    return layers.apply(model, params, users, items)


def init_params(config: NeuMFConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[NeuMF, Dict[str, torch.Tensor]]:
    """``(model, params)`` with flax's default initializers
    (:func:`~autodist_tpu_torch.models.layers.init_params`) drawn from a
    ``torch.Generator`` seeded with ``seed``; the values differ from the JAX
    package's."""
    model = NeuMF(config)
    return model, layers.init_params(model, seed, device)


def make_loss_fn(model: NeuMF) -> Callable:
    """The mean sigmoid cross entropy over ``{"users", "items", "labels"}``,
    in the numerically stable form ``max(z, 0) - z y + log1p(exp(-|z|))``."""

    def loss_fn(params, batch):
        logits = apply(model, params, batch["users"], batch["items"])
        labels = batch["labels"].float()
        return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
                          + torch.log1p(torch.exp(-logits.abs())))

    return loss_fn


def synthetic_batch(config: NeuMFConfig, batch_size: int, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """The JAX package's synthetic batch, value for value."""
    rng = np.random.RandomState(seed)
    return {
        "users": rng.randint(0, config.num_users, size=(batch_size,)).astype(np.int32),
        "items": rng.randint(0, config.num_items, size=(batch_size,)).astype(np.int32),
        "labels": rng.randint(0, 2, size=(batch_size,)).astype(np.float32),
    }
