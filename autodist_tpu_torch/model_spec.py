"""ModelSpec: metadata about the parameters of a training step.

Counterpart of ``autodist_tpu/model_spec.py:22-105``, over a flat
``{name: tensor}`` dict (a module's ``state_dict`` or named parameters)
instead of a JAX tree. Names are the JAX package's: a dotted state-dict key
``block_0.attn.query.kernel`` reads ``block_0/attn/query/kernel``, and
parameters are listed in the JAX tree's order (sorted path components), so
one strategy names the same parameters in the same order in both packages.

Sparse-gradient detection (``model_spec.py:154-278``): the JAX package
walks the loss's jaxpr; the port walks its ATen graph, traced once with
``make_fx`` on fake CPU tensors of the params' and the example batch's
shapes and dtypes (no memory is copied and no kernel runs: on CPU tensors
the kernel wrappers take their plain versions, symbolically). A parameter
is sparse when every op that reads it is of the gather family
(``embedding``, ``index.Tensor``, ``index_select``, or the slice that
stands for ``dynamic_slice``); a cast before the gather (an embedding
table cast to bf16) is a use of another kind, so the table is dense, as in
the JAX package. Its index leaf is the batch leaf every one of its gathers
reads, followed back through value-preserving ops (view, reshape,
unsqueeze, cast, ...); a slice or any arithmetic on the indices loses it,
and the synchronizer then keeps the dense wire.
"""

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
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
                     *example_args) -> "ModelSpec":
        """With the sparse parameters and their index leaves that the walk of
        ``loss_fn(params, *example_args)`` finds."""
        graph = _trace(loss_fn, params, example_args)
        sparse = detect_sparse_params(graph)
        sources = detect_sparse_index_sources(graph)
        return cls(params, sparse_names=sparse,
                   index_leaves={n: sources[n] for n in sparse if n in sources})

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


# --- sparse-gradient detection by a walk of the ATen graph

# A slice counts as a gather: ATen has one op for ``x[a:b]`` and for the
# JAX package's ``dynamic_slice_in_dim`` (the positional table). So a plain
# version of a kernel that reads a parameter table must not slice it (the
# fused head's splits its table instead): a table that a kernel reads whole
# is dense, as an operand of ``pallas_call`` is in the JAX package.
# ``tests/test_torch_sparse_walk.py`` walks each kernel wrapper's plain
# version to hold this.
_GATHER_OPS = {"aten::embedding", "aten::index.Tensor", "aten::index_select",
               "aten::slice.Tensor", "aten::narrow"}
# Ops whose output holds exactly the input's values (re-laid out or cast):
# index provenance flows through them (``_IDX_EXACT_PRIMS``).
_IDX_EXACT_OPS = {"aten::view", "aten::_unsafe_view", "aten::reshape", "aten::unsqueeze",
                  "aten::squeeze.dim", "aten::squeeze", "aten::_to_copy", "aten::clone",
                  "aten::alias", "aten::detach", "aten::lift_fresh_copy", "aten::expand",
                  "aten::permute", "aten::t", "aten::transpose.int", "aten::contiguous"}


def _op_name(node) -> str:
    target = node.target
    name = getattr(target, "name", None)
    if callable(name):
        name = name()
    if not isinstance(name, str):
        return str(target)
    return name[:-len(".default")] if name.endswith(".default") else name


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in the JAX tree's order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(tree, leaves):
    if isinstance(tree, Mapping):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _trace(loss_fn: Callable, params: Mapping[str, torch.Tensor], example_args):
    """``(graph, {placeholder: ("param", name)} | ("arg", leaf name))`` of
    ``loss_fn(params, *example_args)`` traced on fake CPU tensors, or None
    when it does not trace (no detection, as in the JAX package)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    keys = list(params)
    args = [_flatten(a) for a in example_args]
    arg_names = []
    for pos, flat in enumerate(args):
        # A single batch argument (the session's signature) keeps bare names.
        prefix = f"{pos}/" if len(example_args) > 1 else ""
        arg_names += [prefix + "/".join(path) for path, _ in flat]
    arg_leaves = [leaf for flat in args for _, leaf in flat]
    tensor_at = [isinstance(l, (torch.Tensor, np.ndarray)) for l in arg_leaves]

    def fake_of(x):
        t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
        return torch.empty(tuple(t.shape), dtype=t.dtype)

    try:
        with FakeTensorMode():
            fake_params = [fake_of(params[k]) for k in keys]
            fake_args = [fake_of(l) for l, is_t in zip(arg_leaves, tensor_at) if is_t]
    except Exception:  # noqa: BLE001 — an odd leaf: no detection
        return None

    def flat_loss(*flat):
        tree = dict(zip(keys, flat[:len(keys)]))
        tensors = iter(flat[len(keys):])
        leaves = iter([next(tensors) if is_t else l
                       for l, is_t in zip(arg_leaves, tensor_at)])
        rebuilt = [_rebuild(a, leaves) for a in example_args]
        return loss_fn(tree, *rebuilt)

    try:
        graph = make_fx(flat_loss, tracing_mode="fake")(*fake_params, *fake_args).graph
    except Exception:  # noqa: BLE001 — tracing failed: no detection
        return None
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    names = [("param", _path_name(k)) for k in keys]
    names += [("arg", n) for n, is_t in zip(arg_names, tensor_at) if is_t]
    return graph, dict(zip(placeholders, names))


def detect_sparse_params(traced) -> List[str]:
    """Names of the parameters whose every use in the traced loss is a
    gather (``detect_sparse_params``, ``model_spec.py:154-184``)."""
    if traced is None:
        return []
    _, origin = traced
    out = []
    for node, (kind, name) in origin.items():
        uses = {_op_name(u) for u in node.users}
        if kind == "param" and uses and uses <= _GATHER_OPS:
            out.append(name)
    return out


def _index_arg(node):
    """The index operand of a gather node with one (None for a slice)."""
    op = _op_name(node)
    if op == "aten::embedding":
        return node.args[1]
    if op == "aten::index_select" and node.args[1] == 0:
        return node.args[2]
    if op == "aten::index.Tensor":
        indices = node.args[1]
        if len(indices) == 1 and indices[0] is not None:
            return indices[0]
    return None


def detect_sparse_index_sources(traced) -> Dict[str, str]:
    """``{param name: batch leaf}`` for each parameter whose every gather's
    indices are that batch leaf's values (``detect_sparse_index_sources``,
    ``model_spec.py:197-278``): provenance flows from a batch placeholder
    through value-preserving ops only; a gather whose indices lose it, or a
    second leaf, drops the parameter."""
    if traced is None:
        return {}
    graph, names = traced
    origin: Dict[Any, Tuple[str, str]] = dict(names)
    gathers: Dict[str, set] = {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        op = _op_name(node)
        if op in _GATHER_OPS:
            table = origin.get(node.args[0])
            if table is not None and table[0] == "param":
                idx = _index_arg(node)
                if idx is not None or op not in ("aten::slice.Tensor", "aten::narrow"):
                    src = origin.get(idx)
                    gathers.setdefault(table[1], set()).add(
                        src[1] if src is not None and src[0] == "arg" else None)
        elif op in _IDX_EXACT_OPS and node.args and node.args[0] in origin:
            origin[node] = origin[node.args[0]]
    return {param: leaves.pop() for param, leaves in gathers.items()
            if len(leaves) == 1 and None not in leaves}
