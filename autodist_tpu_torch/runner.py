"""DistributedRunner: executes a compiled strategy
(``autodist_tpu/runner.py``: ``init`` :281, ``shard_batch`` :561-600,
``run`` :936, ``evaluate`` :1029).

One process per device: each rank runs a runner over the same strategy and
keeps the rows of the global batch its data index holds (``shard_batch``),
and the gradient fn combines the ranks' gradients
(:mod:`autodist_tpu_torch.parallel.synchronization`).

PyTorch runs eagerly, so there is no compiled step to cache: ``run`` computes
the gradients, applies one optimizer step and returns. The state is updated
in place (``run`` returns the same :class:`TrainState`), where the JAX runner
returns a new one.

Gradient accumulation keeps the JAX runner's ``MicroBatched`` semantics
(``runner.py:74-95,322-356``): batch leaves are split contiguously into
``[k, B/k, ...]``, the micro-gradients are summed and divided by ``k``, the
reported loss is the mean of the micro losses, and the optimizer steps once.
"""

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel import synchronization
from autodist_tpu_torch.parallel.mesh import DeviceMesh, joined_mesh
from autodist_tpu_torch.parallel.plan import DP_AXES, ShardingPlan


class MicroBatched:
    """Marker around a batch leaf laid out ``[accumulation_steps, micro, ...]``."""

    def __init__(self, value: torch.Tensor):
        self.value = value


class ShardedBatch(dict):
    """A dict batch that :meth:`DistributedRunner.shard_batch` already laid
    out: this rank's rows, on its device. ``run`` and ``shard_batch`` take it
    as it is (the JAX runner's arrays carry their sharding instead)."""


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack_trees(trees):
    """Trees of one structure -> one tree whose leaves are the stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees(list(parts)) for parts in zip(*trees))
    return torch.stack([torch.as_tensor(t) for t in trees])


def _fold(batch):
    """MicroBatched leaves back to their logical ``[B, ...]`` rows."""
    return _tree_map(lambda l: l.value.reshape(-1, *l.value.shape[2:])
                     if isinstance(l, MicroBatched) else l, batch)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclasses.dataclass
class TrainState:
    """Step count, parameters (leaf tensors keyed by state-dict key) and the
    optimizer that owns their update state."""

    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer


class DistributedRunner:
    """Synchronous data-parallel runner of a compiled strategy."""

    def __init__(self, compiled_strategy, model_spec: ModelSpec, loss_fn: Callable,
                 optimizer: Callable, device: torch.device,
                 plan: Optional[ShardingPlan] = None, accumulation_steps: int = 1,
                 batch_size: Optional[int] = None, mesh: Optional[DeviceMesh] = None,
                 has_aux: bool = False):
        """``optimizer`` is a factory: ``optimizer(list_of_params)`` returns a
        ``torch.optim.Optimizer`` (``lambda p: torch.optim.Adam(p, lr=1e-3)``).
        ``mesh`` defaults to the plan's mesh over the joined process group.
        Every rank of the mesh runs its own runner: the process group's world
        size must be the mesh's device count. With ``has_aux`` the loss
        returns ``(loss, aux)``."""
        if accumulation_steps < 1:
            raise ValueError("accumulation_steps must be >= 1")
        self.plan = plan if plan is not None \
            else ShardingPlan.from_strategy(compiled_strategy, model_spec)
        self.device = device
        self._model_spec = model_spec
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._accum = accumulation_steps
        self._batch_size = batch_size
        self._has_aux = has_aux
        self._dp = self.plan.dp_size
        self.mesh = mesh if mesh is not None else joined_mesh(self.plan.mesh_axes)
        self._grad_fn = synchronization.make_grad_fn(
            self.plan, model_spec, self.mesh, loss_fn, has_aux=has_aux)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.plan.num_devices:
            raise RuntimeError(f"the mesh {dict(self.plan.mesh_axes)} has "
                               f"{self.plan.num_devices} devices but {world} processes "
                               f"run it (one process per device)")
        self._data_index = self.mesh.index(DP_AXES)

    # ------------------------------------------------------------------- state
    def init(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """Fresh leaf copies of ``params`` on the runner's device (the caller's
        tensors are never updated), and the optimizer over the trainable ones
        in the model spec's order."""
        missing = set(self._model_spec.keys.values()) - set(params)
        if missing:
            raise ValueError(f"params lack {sorted(missing)}")
        placed = {}
        for name, key in self._model_spec.keys.items():
            leaf = params[key].detach().to(self.device, copy=True)
            placed[key] = leaf.requires_grad_(self._model_spec[name].trainable)
        trainable = [placed[self._model_spec.keys[n]] for n in self._model_spec.trainable]
        return TrainState(step=0, params=placed, optimizer=self._optimizer(trainable))

    # ------------------------------------------------------------------- batch
    @staticmethod
    def _leading_dims(batch) -> Dict[int, int]:
        return dict(collections.Counter(
            int(leaf.shape[0]) for leaf in _leaves(batch)
            if not isinstance(leaf, MicroBatched) and np.ndim(leaf) >= 1))

    def _infer_batch_dim(self, dims: Dict[int, int], split: int) -> int:
        """The global batch size: ``batch_size=`` if given, else the one
        leading dim divisible by ``split`` when it is also the most common;
        anything ambiguous raises (``runner.py:483-523``)."""
        if self._batch_size is not None:
            return self._batch_size
        if not dims:
            return 0
        top = max(dims.values())
        modal = {d for d, c in dims.items() if c == top}
        splittable = sorted(d for d in dims if d % split == 0)
        if len(splittable) == 1 and modal == {splittable[0]}:
            return splittable[0]
        if len(splittable) > 1:
            raise ValueError(
                f"Ambiguous batch dimension for gradient accumulation: leading "
                f"dims {splittable} are all divisible by accumulation_steps*dp="
                f"{split}; pass batch_size= to pick one")
        if len(splittable) == 1:
            raise ValueError(
                f"Cannot infer the batch dimension for gradient accumulation: "
                f"the only leading dim divisible by accumulation_steps*dp="
                f"{split} is {splittable[0]}, but the most common leading dim "
                f"is {sorted(modal)}; pass batch_size= to pick one")
        return max(modal)

    def place(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(self.device, non_blocking=True)

    def shard_batch(self, batch, accumulation: Optional[int] = None,
                    place: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """This rank's rows of the global ``batch``, on the runner's device.
        With gradient accumulation (``k > 1``), leaves whose leading dim is
        the batch size B are laid out ``[k, B/k, ...]`` first and come back as
        :class:`MicroBatched` holding this data rank's contiguous ``1/dp``
        chunk of every micro-batch (``P(None, DP_AXES)``); other leaves whose
        leading dim divides over the dp data ranks keep their own chunk, and
        the rest are whole on every rank. ``accumulation`` overrides the
        runner's ``k`` (evaluate passes 1); ``place`` moves each host tensor
        to the device (default :meth:`place`)."""
        if isinstance(batch, ShardedBatch):
            return batch
        k = self._accum if accumulation is None else accumulation
        dp, data_index = self._dp, self._data_index
        place = place or self.place
        batch_dim = 0
        if k > 1:
            dims = self._leading_dims(batch)
            batch_dim = self._infer_batch_dim(dims, k * self._dp)
            if batch_dim not in dims:
                raise ValueError(
                    f"batch_size={batch_dim} matches no leaf's leading dim "
                    f"(present: {sorted(dims)}); nothing would be micro-split "
                    f"for accumulation_steps={k}")

        def put(leaf):
            if isinstance(leaf, MicroBatched):
                return leaf
            t = torch.as_tensor(leaf)
            if k > 1 and t.dim() >= 1 and t.shape[0] == batch_dim:
                if t.shape[0] % (k * dp):
                    raise ValueError(
                        f"Global batch {t.shape[0]} is not divisible into "
                        f"accumulation_steps={k} micro-batches over {dp} "
                        f"data replicas; make it divisible by {k * dp}")
                micro = t.reshape(k, t.shape[0] // k, *t.shape[1:])
                if dp > 1:
                    micro = micro[:, self.plan.batch_rows(micro.shape[1], data_index)]
                return MicroBatched(place(micro))
            if dp > 1 and t.dim() >= 1 and t.shape[0] % dp == 0:
                t = t[self.plan.batch_rows(t.shape[0], data_index)]
            return place(t)

        out = _tree_map(put, batch)
        return ShardedBatch(out) if isinstance(out, dict) else out

    # -------------------------------------------------------------------- step
    def _accumulate(self, params, batch):
        """Micro-gradients summed on this rank and divided by ``k``, then one
        all-reduce for the step; the loss is the micro losses' mean. Aux
        contracts as the JAX runner's does (``runner.py:322-356``): a leaf
        whose second stacked dim is the micro-batch's rows folds back to
        ``[rows, ...]``, any other averages over the micro-batches."""
        gsum, losses, auxes = None, [], []
        for i in range(self._accum):
            micro = _tree_map(lambda l: l.value[i] if isinstance(l, MicroBatched) else l,
                              batch)
            grads, loss, aux = self._grad_fn.local(params, micro)
            if gsum is None:
                gsum = grads
            else:
                for key, g in grads.items():
                    gsum[key].add_(g)
            losses.append(loss)
            auxes.append(aux)
        grads = {key: g.div_(self._accum) for key, g in gsum.items()}
        grads, loss = self._grad_fn.sync(grads, torch.stack(losses).mean())
        micro_b = next((l.value.shape[1] for l in _leaves(batch)
                        if isinstance(l, MicroBatched)), None)
        aux = _tree_map(lambda a: a.reshape(-1, *a.shape[2:])
                        if a.dim() >= 2 and a.shape[1] == micro_b else a.mean(0),
                        _stack_trees(auxes)) if self._has_aux else ()
        return grads, loss, aux

    def run(self, state: TrainState, batch, fetches: Optional[Callable] = None):
        """One synchronized training step; returns ``(state, fetched)``.

        ``fetched`` is the loss, a 0-dim tensor on the device that reading
        waits for (``(loss, aux)`` with ``has_aux``). With ``fetches=fn``,
        ``fn(params, batch)`` runs on the pre-update params and this rank's
        rows of the batch (micro-batches folded back) and ``fetched`` is
        ``(default, fn_result)``. The loss is the global one; aux and fetches
        are computed on this rank's rows."""
        sharded = self.shard_batch(batch)
        if self._accum > 1:
            grads, loss, aux = self._accumulate(state.params, sharded)
        else:
            grads, loss, aux = self._grad_fn(state.params, sharded)
        extra = None
        if fetches is not None:
            with torch.no_grad(), synchronization.step_mesh(self.mesh):
                extra = _tree_map(
                    lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                    fetches(state.params, _fold(sharded)))
        for key, g in grads.items():
            state.params[key].grad = g
        state.optimizer.step()
        for key in grads:
            state.params[key].grad = None
        state.step += 1
        default = (loss, aux) if self._has_aux else loss
        return state, ((default, extra) if fetches is not None else default)

    def evaluate(self, state: TrainState, batch, fn: Optional[Callable] = None):
        """``fn(params, batch)`` (default: the loss) on this rank's rows,
        without gradients or an update; ``state`` is left as it is. A 0-dim
        floating result is averaged over the data and seq ranks, as the
        training loss is, so it is the global value."""
        fn = fn if fn is not None else self._loss_fn
        batch = (ShardedBatch(_fold(batch)) if isinstance(batch, ShardedBatch)
                 else self.shard_batch(_fold(batch), accumulation=1))
        with torch.no_grad(), synchronization.step_mesh(self.mesh):
            out = fn(state.params, batch)
        group = self.mesh.group(synchronization.SYNC_AXES)
        if group is not None and isinstance(out, torch.Tensor) and out.dim() == 0 \
                and out.is_floating_point():
            out = out.clone()
            dist.all_reduce(out, group=group)
            out = out / dist.get_world_size(group)
        return out


def step_function(runner: DistributedRunner, params: Dict[str, torch.Tensor]) -> Callable:
    """``step(batch, fetches=None)`` over ``runner``, returning what
    :meth:`DistributedRunner.run` fetches and carrying the training state
    inside, started from ``params``; ``step.runner``, ``step.get_state()``
    and ``step.evaluate(batch, fn=None)`` expose it (what
    ``AutoDist.function`` returns)."""
    state = runner.init(params)

    def step(batch, fetches=None):
        _, fetched = runner.run(state, batch, fetches=fetches)
        return fetched

    step.runner = runner
    step.get_state = lambda: state
    step.evaluate = lambda batch, fn=None: runner.evaluate(state, batch, fn)
    return step
