"""DistributedRunner: executes a compiled strategy
(``autodist_tpu/runner.py``: ``init`` :281, ``shard_batch`` :561-600,
``run`` :936, ``evaluate`` :1029).

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
from autodist_tpu_torch.parallel.plan import ShardingPlan


class MicroBatched:
    """Marker around a batch leaf laid out ``[accumulation_steps, micro, ...]``."""

    def __init__(self, value: torch.Tensor):
        self.value = value


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


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
                 batch_size: Optional[int] = None,
                 seq_group: Optional[dist.ProcessGroup] = None):
        """``optimizer`` is a factory: ``optimizer(list_of_params)`` returns a
        ``torch.optim.Optimizer`` (``lambda p: torch.optim.Adam(p, lr=1e-3)``).
        ``seq_group`` is the process group of the mesh's ``seq`` axis when it
        has more than one rank. Every rank of the mesh runs its own runner:
        the process group's world size must be the mesh's device count."""
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
        self._dp = self.plan.dp_size
        self._grad_fn = synchronization.make_grad_fn(
            self.plan, model_spec, self._dp, loss_fn, seq_group=seq_group)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.plan.num_devices:
            raise RuntimeError(f"the mesh {dict(self.plan.mesh_axes)} has "
                               f"{self.plan.num_devices} devices but {world} processes "
                               f"run it (one process per device)")

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

    def shard_batch(self, batch, accumulation: Optional[int] = None):
        """Place the batch on the runner's device. With gradient accumulation
        (``k > 1``), leaves whose leading dim is the batch size come back as
        :class:`MicroBatched` ``[k, B/k, ...]``; the reshape is a view.
        ``accumulation`` overrides the runner's ``k`` (evaluate passes 1)."""
        k = self._accum if accumulation is None else accumulation
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
            t = torch.as_tensor(leaf).to(self.device, non_blocking=True)
            if k > 1 and t.dim() >= 1 and t.shape[0] == batch_dim:
                if t.shape[0] % (k * self._dp):
                    raise ValueError(
                        f"Global batch {t.shape[0]} is not divisible into "
                        f"accumulation_steps={k} micro-batches over {self._dp} "
                        f"data replicas; make it divisible by {k * self._dp}")
                return MicroBatched(t.reshape(k, t.shape[0] // k, *t.shape[1:]))
            return t

        return _tree_map(put, batch)

    # -------------------------------------------------------------------- step
    def _accumulate(self, params, batch) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        gsum, losses = None, []
        for i in range(self._accum):
            micro = _tree_map(lambda l: l.value[i] if isinstance(l, MicroBatched) else l,
                              batch)
            grads, loss = self._grad_fn(params, micro)
            if gsum is None:
                gsum = grads
            else:
                for key, g in grads.items():
                    gsum[key].add_(g)
            losses.append(loss)
        grads = {key: g.div_(self._accum) for key, g in gsum.items()}
        return grads, torch.stack(losses).mean()

    def run(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        """One synchronized training step; returns ``(state, loss)``.
        ``loss`` is a 0-dim tensor on the device: reading it waits for the
        step."""
        sharded = self.shard_batch(batch)
        if self._accum > 1:
            grads, loss = self._accumulate(state.params, sharded)
        else:
            grads, loss = self._grad_fn(state.params, sharded)
        for key, g in grads.items():
            state.params[key].grad = g
        state.optimizer.step()
        for key in grads:
            state.params[key].grad = None
        state.step += 1
        return state, loss

    def evaluate(self, state: TrainState, batch, fn: Optional[Callable] = None):
        """``fn(params, batch)`` (default: the loss) without gradients or an
        update; ``state`` is left as it is."""
        fn = fn if fn is not None else self._loss_fn
        batch = _tree_map(lambda l: l.value.reshape(-1, *l.value.shape[2:])
                          if isinstance(l, MicroBatched) else l, batch)
        with torch.no_grad():
            return fn(state.params, self.shard_batch(batch, accumulation=1))


def step_function(runner: DistributedRunner, params: Dict[str, torch.Tensor]) -> Callable:
    """``step(batch) -> loss`` over ``runner``, carrying the training state
    inside, started from ``params``; ``step.runner``, ``step.get_state()`` and
    ``step.evaluate(batch, fn=None)`` expose it (what ``AutoDist.function``
    returns)."""
    state = runner.init(params)

    def step(batch):
        _, loss = runner.run(state, batch)
        return loss

    step.runner = runner
    step.get_state = lambda: state
    step.evaluate = lambda batch, fn=None: runner.evaluate(state, batch, fn)
    return step
