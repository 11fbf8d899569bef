"""Bookkeeping around the port's kernels.

- **Launch counts.** Every kernel wrapper adds one to its ``launches``
  where it launches its kernel. A CUDA graph replay launches what its
  capture recorded while no Python runs, so the runner measures what a
  capture added (:func:`recorded_launches`, which also undoes it: a capture
  launches nothing) and adds it again at every replay (:func:`add_launches`).
- **Static step costs** (:class:`StepCost`, behind
  ``DistributedRunner.plan_costs``): a dispatch mode that counts, for the
  ATen ops of one step traced on fake CPU tensors, the floating-point
  operations (``torch.utils.flop_counter``'s formulas), the bytes each op
  reads and writes, and the ops that launch work on the card. A kernel
  wrapper called on such a tensor takes its plain version under
  :func:`kernel`, which puts the kernel's own numbers (its HBM traffic, its
  tensor-core operations, its launches) in place of the plain version's:
  the fused head's ``[N, V]`` logits never reach HBM.
"""

import contextlib
import threading
from typing import Dict, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_local = threading.local()

# Ops that launch nothing on the card: allocations, metadata and reads of a
# scalar (a host sync, not a launch).
_NO_LAUNCH = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "lift_fresh", "detach", "alias", "_local_scalar_dense", "sym_size",
              "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
              "_has_compatible_shallow_copy_type", "set_"}


def counted_wrappers():
    """The wrappers that count their launches: the fused head's three
    kernels, its table pack, and the four flash kernels (with their hd-128
    instantiations' counts)."""
    from autodist_tpu_torch.ops import flash_attention, fused_xent
    return fused_xent.KERNELS + (fused_xent.xent_pack_w,) + flash_attention.KERNELS \
        + flash_attention.KERNELS_HD128


def launch_counts() -> Dict[str, int]:
    """Each counted wrapper's launches so far, by name."""
    return {fn.__name__: fn.launches for fn in counted_wrappers()}


def add_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' counters: what one
    replay of a captured graph launched."""
    for fn in counted_wrappers():
        fn.launches += int(counts.get(fn.__name__, 0))


@contextlib.contextmanager
def recorded_launches():
    """Yield a dict that is filled, on exit, with the launches each wrapper
    counted inside the block (those that counted any), and set every
    counter back to its value before the block."""
    before = launch_counts()
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        now = launch_counts()
        delta.update({k: now[k] - before[k] for k in now if now[k] != before[k]})
        for fn in counted_wrappers():
            fn.launches = before[fn.__name__]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class StepCost(TorchDispatchMode):
    """Counts ``flops``, ``bytes_accessed`` and ``launches`` of the ATen ops
    dispatched under it (enter it above a ``FakeTensorMode``, so nothing
    runs). View ops and allocations launch nothing and move no bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.launches = 0
        self._inside_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside_kernel or func.namespace != "aten":
            return out
        name = func.__name__.split(".")[0]
        if getattr(func, "is_view", False) or name in _NO_LAUNCH:
            return out
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += float(count(*args, **kwargs, out_val=out))
        self.bytes_accessed += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self.launches += 1
        return out

    def __enter__(self):
        self._prior = getattr(_local, "cost", None)
        _local.cost = self
        return super().__enter__()

    def __exit__(self, *exc):
        _local.cost = self._prior
        return super().__exit__(*exc)


@contextlib.contextmanager
def kernel(nbytes: float, flops: float, launches: int = 1):
    """Around a kernel wrapper's plain version under a :class:`StepCost`:
    the plain version's ops are not counted and the kernel's ``nbytes``,
    ``flops`` and ``launches`` are. Outside a probe it does nothing."""
    cost = getattr(_local, "cost", None)
    if cost is None:
        yield
        return
    cost._inside_kernel += 1
    try:
        yield
    finally:
        cost._inside_kernel -= 1
    if not cost._inside_kernel:
        cost.bytes_accessed += float(nbytes)
        cost.flops += float(flops)
        cost.launches += int(launches)


def probing() -> bool:
    """Whether a :class:`StepCost` probe is counting on this thread."""
    return getattr(_local, "cost", None) is not None
