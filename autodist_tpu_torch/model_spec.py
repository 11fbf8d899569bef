"""ModelSpec: metadata about the parameters of a training step.

Counterpart of ``autodist_tpu/model_spec.py:22-105``, over a flat
``{name: tensor}`` dict (a module's ``state_dict`` or named parameters)
instead of a JAX tree. Names are the JAX package's: a dotted state-dict key
``block_0.attn.query.kernel`` reads ``block_0/attn/query/kernel``, and
parameters are listed in the JAX tree's order (sorted path components), so
one strategy names the same parameters in the same order in both packages.

Sparse-gradient detection: the JAX package walks the loss's jaxpr for
parameters consumed only by gathers (``model_spec.py:154-278``). The port
uses a declared rule instead: a model lists its gather-only parameters and
its loss function carries them as ``loss_fn.sparse_names``;
``sparse_names=`` overrides.
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
                 trainable_filter: Optional[Callable[[str], bool]] = None):
        named = {}
        for key, tensor in params.items():
            name = _path_name(key)
            if name in named:
                raise ValueError(f"Parameter name collision: two keys render as {name!r}")
            named[name] = (key, tensor)
        sparse = set(sparse_names)
        self._names: List[str] = sorted(named, key=lambda n: tuple(n.split("/")))
        self.keys: Dict[str, str] = {n: named[n][0] for n in self._names}
        self.params: Dict[str, ParamSpec] = {}
        for name in self._names:
            tensor = named[name][1]
            self.params[name] = ParamSpec(
                name=name, shape=tuple(tensor.shape), dtype=tensor.dtype,
                sparse=name in sparse,
                trainable=trainable_filter(name) if trainable_filter else True)

    @classmethod
    def from_loss_fn(cls, loss_fn: Callable, params: Mapping[str, torch.Tensor]
                     ) -> "ModelSpec":
        """With the gather-only parameters ``loss_fn`` declares."""
        return cls(params, sparse_names=getattr(loss_fn, "sparse_names", ()))

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
