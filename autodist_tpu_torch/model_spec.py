"""ModelSpec: metadata about the parameters of a training step.

Counterpart of ``autodist_tpu/model_spec.py:22-105``, over a flat
``{name: tensor}`` dict (a module's ``state_dict`` or named parameters)
instead of a JAX tree. Names are the JAX package's: a dotted state-dict key
``block_0.attn.query.kernel`` reads ``block_0/attn/query/kernel``, and
parameters are listed in the JAX tree's order (sorted path components), so
one strategy names the same parameters in the same order in both packages.

Sparse-gradient detection: the JAX package walks the loss's jaxpr for
parameters consumed only by gathers, and for the batch leaf whose values
index each one's gather (``model_spec.py:154-278``). The port uses a
declared rule instead: a model lists its gather-only parameters and its
loss function carries them as ``loss_fn.sparse_names``, and the index leaf
of each as ``loss_fn.index_leaves = {param: batch leaf}`` (only where the
gather reads that leaf as it is: a sliced or transformed index, or two
index leaves, declare none, as the jaxpr walk finds none);
``sparse_names=`` and ``index_leaves=`` override.
"""

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch


def _path_name(key: str) -> str:
    """The JAX package's '/'-joined parameter name for a dotted state-dict key."""
    return key.replace(".", "/") or "param"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Metadata for one trainable parameter."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sparse: bool = False        # gradient is row-sparse (gather-only use)
    trainable: bool = True
    # The batch leaf ('/'-joined path) whose values are this sparse
    # parameter's gather indices: enables the (indices, rows) wire.
    index_leaf: Optional[str] = None

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def byte_size(self) -> int:
        return self.size * torch.empty((), dtype=self.dtype).element_size()


class ModelSpec:
    """Parameter metadata keyed by JAX-style name, in the JAX tree's order."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 sparse_names: Sequence[str] = (),
                 trainable_filter: Optional[Callable[[str], bool]] = None,
                 index_leaves: Optional[Mapping[str, str]] = None):
        named = {}
        for key, tensor in params.items():
            name = _path_name(key)
            if name in named:
                raise ValueError(f"Parameter name collision: two keys render as {name!r}")
            named[name] = (key, tensor)
        sparse = set(sparse_names)
        index_leaves = dict(index_leaves or {})
        self._names: List[str] = sorted(named, key=lambda n: tuple(n.split("/")))
        self.keys: Dict[str, str] = {n: named[n][0] for n in self._names}
        self.params: Dict[str, ParamSpec] = {}
        for name in self._names:
            tensor = named[name][1]
            self.params[name] = ParamSpec(
                name=name, shape=tuple(tensor.shape), dtype=tensor.dtype,
                sparse=name in sparse,
                trainable=trainable_filter(name) if trainable_filter else True,
                index_leaf=index_leaves.get(name) if name in sparse else None)

    @classmethod
    def from_loss_fn(cls, loss_fn: Callable, params: Mapping[str, torch.Tensor],
                     sparse_names: Optional[Sequence[str]] = None,
                     index_leaves: Optional[Mapping[str, str]] = None) -> "ModelSpec":
        """With the gather-only parameters and index leaves ``loss_fn``
        declares, unless given here."""
        if sparse_names is None:
            sparse_names = getattr(loss_fn, "sparse_names", ())
        if index_leaves is None:
            index_leaves = getattr(loss_fn, "index_leaves", None)
        return cls(params, sparse_names=sparse_names, index_leaves=index_leaves)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def trainable(self) -> Dict[str, ParamSpec]:
        return {n: p for n, p in self.params.items() if p.trainable}

    def __getitem__(self, name: str) -> ParamSpec:
        return self.params[name]

    def __repr__(self):
        return (f"ModelSpec({len(self.params)} params, "
                f"{sum(p.byte_size for p in self.params.values())} bytes)")
