"""Weights between the two packages: a JAX params tree of numpy arrays and
the port's flat ``{state-dict key: tensor}`` dict.

Keys are the tree's paths joined by dots (``block_0/attn/query/kernel``
becomes ``block_0.attn.query.kernel``) and every array keeps its JAX layout
and dtype, so one initialization feeds both packages.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch


def from_jax_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    flat state dict of CPU tensors, each a copy."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(from_jax_params(value, prefix=name + "."))
        else:
            out[name] = torch.from_numpy(np.array(value, copy=True))
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat state dict -> nested dict of numpy arrays, the JAX tree's shape."""
    out: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor.detach().cpu().numpy()
    return out
