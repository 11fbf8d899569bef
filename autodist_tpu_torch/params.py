"""Weights between the two packages: a JAX params tree of numpy arrays and
the port's flat ``{state-dict key: tensor}`` dict.

Keys are the tree's paths joined by dots (``block_0/attn/query/kernel``
becomes ``block_0.attn.query.kernel``) and every array keeps its JAX layout
and dtype, so one initialization feeds both packages. A JAX run's padded
storage (uneven partitioning) comes across cut to the logical shapes, and
its compressor state as the port's ``TrainState.ef_state``.
"""

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def from_jax_params(tree: Mapping[str, Any], prefix: str = "",
                    logical_shapes: Optional[Mapping[str, Sequence[int]]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    flat state dict of CPU tensors, each a copy; an array whose key is in
    ``logical_shapes`` is cut to that shape (a padded storage array)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(from_jax_params(value, prefix=name + ".",
                                       logical_shapes=logical_shapes))
        else:
            array = np.asarray(value)
            if logical_shapes and name in logical_shapes:
                array = array[tuple(slice(0, d) for d in logical_shapes[name])]
            out[name] = torch.from_numpy(np.array(array, copy=True))
    return out


def from_jax_compressor_state(tree: Mapping[str, Any], data_index: int = 0,
                              prefix: str = "") -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX run's compressor-state tree (``TrainState.ef_state``: per
    parameter an ``EFState`` or ``PowerSGDState`` whose ``error`` has one
    row per data rank, or a 0-d placeholder) -> the port's ``ef_state`` of
    data rank ``data_index``: ``{state-dict key: {"error": its residual,
    "q": PowerSGD's Q}}``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(from_jax_compressor_state(value, data_index, prefix=name + "."))
        elif hasattr(value, "error"):
            entry = {"error": torch.from_numpy(np.array(np.asarray(value.error)[data_index]))}
            if hasattr(value, "q"):
                entry["q"] = torch.from_numpy(np.array(value.q, copy=True))
            out[name] = entry
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
