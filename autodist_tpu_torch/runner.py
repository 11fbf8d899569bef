"""DistributedRunner: executes a compiled strategy
(``autodist_tpu/runner.py``: ``init`` :281, the step body :284-381,
``shard_batch`` :561-600, ``run`` :936, ``evaluate`` :1029).

One process per device: each rank runs a runner over the same strategy and
keeps the rows of the global batch its data index holds (``shard_batch``),
and the gradient fn combines the ranks' gradients
(:mod:`autodist_tpu_torch.parallel.synchronization`).

The state lives as the plan lays it out (:mod:`autodist_tpu_torch.parallel.layout`):

- A parameter partitioned on a ``model`` axis of more than one rank is
  stored as this rank's shard, zero-padded where the dim does not tile; it
  is all-gathered and unpadded before the user's loss, which reads it at
  its logical shape (compute stays replicated across the model ranks, as
  the JAX package's values are), and its gradient is padded and sliced back
  to the shard, so the pad region's gradient, moments and values stay 0.
- A parameter partitioned on the ``expert`` or ``pipe`` axis (the
  ``ExpertParallel`` and ``Pipeline`` builders) reaches the loss as this
  rank's shard, ``[E/k, ...]`` or ``[L/S, ...]``: each rank computes with
  only its experts or its stage, as under the JAX package's ``P("expert")``
  sharding and ``shard_map`` over ``pipe``. The model finds its group on
  the current mesh: the runner makes its mesh current (``with mesh:``)
  around every call of the loss, in ``run``, in ``run_many``'s warm-up and
  capture, in ``evaluate`` and in ``plan_costs``.
- Under PS nodes, or with ``zero=`` / ``AUTODIST_ZERO`` under any plan, a
  parameter whose optimizer state shards (``opt_pspec``) is updated
  ZeRO-1 style: its gradient is reduce-scattered, the optimizer updates
  this rank's shard (it owns a leaf of the shard's shape, so its moments
  are the shard's), and the updated shards are all-gathered back into the
  storage (the lowering XLA emits from ``constrain_update``,
  ``constrain_opt`` and ``constrain_params``).
- The codecs' state (error-feedback residuals, PowerSGD's Q) rides in
  :attr:`TrainState.ef_state`.

PyTorch runs eagerly, so there is no compiled step to cache: ``run`` computes
the gradients, applies one optimizer step and returns. The state is updated
in place (``run`` returns the same :class:`TrainState`), where the JAX runner
returns a new one.

Gradient accumulation keeps the JAX runner's ``MicroBatched`` semantics
(``runner.py:74-95,322-356``): batch leaves are split contiguously into
``[k, B/k, ...]``, the micro-gradients are summed and divided by ``k``, the
reported loss is the mean of the micro losses, and the optimizer steps once.

``run_many`` (``runner.py:982-1024``) runs K steps of a :class:`BatchBlock`
as one dispatch. On a CUDA device the K steps (forward, backward with the
hand-written kernels, gradient sync, optimizer step, ZeRO gather) are
captured into one ``torch.cuda.CUDAGraph``, cached per (K, ``fetches``,
the block's signature), and replayed; the block enters the graph's static
``[K, ...]`` inputs by one ``copy_`` a leaf. A runner's first block on the
card runs eagerly on a side stream before the capture, as PyTorch requires
(it creates the optimizer state and every lazy handle); later blocks and
signatures are captured and replayed straight away. A plan that cannot be
captured raises ``RuntimeError`` with the cause: there is no eager path on
the card. The optimizer runs with ``capturable=True`` on the card in
``run()`` and in the graph alike (its step counters on the device), so
``run_many(K)`` equals K ``run()`` calls bit for bit. On the CPU (the
tests' path, and gloo ranks) the K steps run in order.

``plan_costs`` (``runner.py:892-932``) executes no step and allocates
nothing on the card: it traces one step's loss and gradient on fake CPU
tensors and the optimizer's update on meta tensors, counting FLOPs, bytes
and launches (:mod:`autodist_tpu_torch.ops.costs`).

Telemetry (``runner.py:138-170,792-835,954-1081``): with spans on, every
dispatch runs in a ``runner.run.dispatch`` / ``runner.run_many.dispatch``
span, and the first dispatch of a new shape signature (``jit.compile``)
counts ``jit.cache_miss`` and adds its seconds to ``jit.compile_s``. The
port has no compiler: these count the BUILD of a signature, its first
eager call or a graph capture (with the eager warm-up that precedes a
runner's first capture), and with the attribution plane on that build
records the signature's ``plan_costs`` as its program cost. With
``health`` (default ``AUTODIST_HEALTH``) each step computes the health
bundle on the device (:func:`autodist_tpu_torch.telemetry.health.device_bundle`),
kept as :attr:`DistributedRunner.last_health` for the train loop to read
at its log boundaries; ``run_many`` reduces its K bundles inside the
captured graph. With health off a step makes not one more launch.
"""

import collections
import dataclasses
import logging
import time
import types
import weakref
import zlib
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, optimizers, telemetry
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.ops import costs
from autodist_tpu_torch.parallel import synchronization
from autodist_tpu_torch.parallel.layout import StateLayout
from autodist_tpu_torch.parallel.mesh import DeviceMesh, joined_mesh, single_device_mesh
from autodist_tpu_torch.parallel.plan import DP_AXES, ShardingPlan, entry_axes
from autodist_tpu_torch.telemetry import health as _health
from autodist_tpu_torch.telemetry import profiling as _profiling

_log = logging.getLogger("autodist_tpu_torch")

# Runners that have captured a run_many graph in this process: shutdown()
# releases their graphs before it destroys the process group.
_GRAPHED: "weakref.WeakSet" = weakref.WeakSet()


class MicroBatched:
    """Marker around a batch leaf laid out ``[accumulation_steps, micro, ...]``."""

    def __init__(self, value: torch.Tensor):
        self.value = value


class ShardedBatch(dict):
    """A dict batch that :meth:`DistributedRunner.shard_batch` already laid
    out: this rank's rows, on its device. ``run`` and ``shard_batch`` take it
    as it is (the JAX runner's arrays carry their sharding instead).
    ``rows`` maps the leading dim of this rank's share of each leaf split
    over the data ranks (micro-batches folded back) to the number of
    micro-batches it folds (1 for a leaf not micro-batched)."""

    rows: Mapping[int, int] = types.MappingProxyType({})


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of its
    structure, leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


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


def _structure(tree):
    """The tree's shape without its leaves (a MicroBatched leaf marked)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "micro" if isinstance(tree, MicroBatched) else "leaf"


def _signature(tree) -> tuple:
    """What a captured program's static inputs depend on: each leaf's
    place, layout, shape, dtype and device."""
    out = []
    for leaf in _leaves(tree):
        t = leaf.value if isinstance(leaf, MicroBatched) else leaf
        if isinstance(t, torch.Tensor):
            out.append((isinstance(leaf, MicroBatched), tuple(t.shape), t.dtype, str(t.device)))
        else:
            out.append(repr(t))
    return (_structure(tree), tuple(out))


class BatchBlock:
    """K laid-out batches stacked along a leading step axis
    (``runner.py:98-116``). Built by :meth:`DistributedRunner.shard_block`
    (or ``prefetch_to_device(..., unroll=K)``) and consumed by
    :meth:`DistributedRunner.run_many`. ``tree`` holds this rank's stacked
    rows on its device (micro-batched leaves ``[K, k, B/k, ...]``),
    ``length`` the steps it carries and ``rows`` what
    :attr:`ShardedBatch.rows` holds for each step."""

    __slots__ = ("tree", "length", "rows")

    def __init__(self, tree, length: int, rows: Optional[Mapping[int, int]] = None):
        self.tree = tree
        self.length = length
        self.rows = types.MappingProxyType(dict(rows or {}))

    def __len__(self) -> int:
        return self.length

    def step(self, i: int):
        """Step ``i``'s batch: views into the block, laid out as
        :meth:`DistributedRunner.shard_batch` lays one out."""
        out = _tree_map(lambda l: MicroBatched(l.value[i]) if isinstance(l, MicroBatched)
                        else l[i] if isinstance(l, torch.Tensor) else l, self.tree)
        if isinstance(out, dict):
            out = ShardedBatch(out)
            out.rows = self.rows
        return out


def _state_tensors(state) -> Dict[tuple, torch.Tensor]:
    """Every tensor a step reads and updates, by place: a captured graph
    holds their addresses, so a step must update them in place."""
    out = {("param", k): t for k, t in state.params.items()}
    for k, t in state.opt_params.items():
        out[("update", k)] = t
        for field, value in state.optimizer.state.get(t, {}).items():
            if isinstance(value, torch.Tensor):
                out[("optimizer", k, field)] = value
    for k, entry in state.ef_state.items():
        for field, value in entry.items():
            out[("codec", k, field)] = value
    return out


def _hyperparameters(optimizer) -> tuple:
    """The optimizer's host-side settings, which a capture bakes in (its
    tensors are read on the card at every replay)."""
    return tuple((i, k, repr(v)) for i, g in enumerate(optimizer.param_groups)
                 for k, v in sorted(g.items())
                 if k != "params" and not isinstance(v, torch.Tensor))


def _clone_outputs(tree):
    return _tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class _CapturedBlock:
    """One captured K-step program: its graph, the static inputs the block
    is copied into, its outputs, the launches each replay makes, and the
    optimizer settings it was captured with."""

    def __init__(self, graph, static, outputs, launches: Dict[str, int], hyper: tuple):
        self.graph, self.static, self.outputs = graph, static, outputs
        self.launches, self.hyper = launches, hyper

    def replay(self, state, block: "BatchBlock"):
        """The block's steps; ``(losses, aux, fetched, bundle)``."""
        def put(dst, src):
            if isinstance(dst, MicroBatched):
                dst.value.copy_(src.value, non_blocking=True)
            elif isinstance(dst, torch.Tensor):
                dst.copy_(src, non_blocking=True)

        _tree_map(put, self.static, block.tree)
        self.graph.replay()
        costs.add_launches(self.launches)
        state.step += block.length
        return _clone_outputs(self.outputs)


class _CompileProbe:
    """Times the first dispatch of a shape signature and books it as a build
    (``runner.py:138-170``): wraps the dispatch span in a ``jit.compile``
    span, and on exit bumps ``jit.cache_miss``, adds the seconds to
    ``jit.compile_s`` and hands them to ``cost_cb`` (the program-cost record
    of the attribution plane). Built only while telemetry is on."""

    __slots__ = ("_inner", "_t0", "_cost_cb")

    def __init__(self, inner, cost_cb=None):
        self._inner = inner
        self._t0 = 0.0
        self._cost_cb = cost_cb

    def __enter__(self):
        self._inner.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        telemetry.counter("jit.cache_miss").inc()
        telemetry.counter("jit.compile_s").inc(dt)
        if self._cost_cb is not None and exc[0] is None:
            self._cost_cb(dt)
        return self._inner.__exit__(*exc)


@dataclasses.dataclass
class TrainState:
    """Step count, parameters (this rank's storage, leaf tensors keyed by
    state-dict key), the optimizer that owns their update state, the codecs'
    state, and the tensors the optimizer updates (``opt_params``: the
    storage itself, or this rank's update shard of it). ``layout`` is the
    runner's, so the saver can address the shards without the runner."""

    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    ef_state: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    opt_params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    layout: Optional[StateLayout] = None


class DistributedRunner:
    """Synchronous data-parallel runner of a compiled strategy."""

    # Every synchronous plan has the fused multi-step path; the async PS
    # runner (parallel/staleness.py) has none.
    supports_run_many = True
    # Whether each process runs its own program, joined to no process group
    # (the async PS runner's processes meet only at the parameter service).
    independent = False

    def __init__(self, compiled_strategy, model_spec: ModelSpec, loss_fn: Callable,
                 optimizer: Callable, device: torch.device,
                 plan: Optional[ShardingPlan] = None, accumulation_steps: int = 1,
                 batch_size: Optional[int] = None, mesh: Optional[DeviceMesh] = None,
                 has_aux: bool = False, zero: Optional[int] = None,
                 health: Optional[bool] = None):
        """``optimizer`` is a factory: ``optimizer(list_of_params)`` returns a
        ``torch.optim.Optimizer`` (``lambda p: torch.optim.Adam(p, lr=1e-3)``).
        ``mesh`` defaults to the plan's mesh over the joined process group.
        Every rank of the mesh runs its own runner: the process group's world
        size must be the mesh's device count. With ``has_aux`` the loss
        returns ``(loss, aux)``. ``zero`` (default ``AUTODIST_ZERO``, 0 off)
        shards the optimizer state and update of every parameter with a
        free axis that tiles over all the data ranks. ``health`` (default
        ``AUTODIST_HEALTH``) computes the health bundle every step."""
        if accumulation_steps < 1:
            raise ValueError("accumulation_steps must be >= 1")
        self.plan = plan if plan is not None \
            else ShardingPlan.from_strategy(compiled_strategy, model_spec)
        self.zero = const.env_int(const.AUTODIST_ZERO, 0) if zero is None else int(zero)
        if self.zero and not self.plan.zero:
            self.plan = self.plan.with_zero_update()
        self.device = device
        self._model_spec = model_spec
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._accum = accumulation_steps
        self._batch_size = batch_size
        self._has_aux = has_aux
        self._dp = self.plan.dp_size
        self.mesh = mesh if mesh is not None else joined_mesh(self.plan.mesh_axes)
        self.layout = StateLayout(self.plan, model_spec, self.mesh or single_device_mesh())
        self._grad_fn = synchronization.make_grad_fn(
            self.plan, model_spec, self.mesh, loss_fn, has_aux=has_aux, layout=self.layout)
        world = dist.get_world_size() if dist.is_initialized() and not self.independent else 1
        if world != self.plan.num_devices:
            raise RuntimeError(f"the mesh {dict(self.plan.mesh_axes)} has "
                               f"{self.plan.num_devices} devices but {world} processes "
                               f"run it (one process per device)")
        self._data_index = self.mesh.index(DP_AXES)
        self._dp_group = self.mesh.group(DP_AXES)
        # The autotuner's plan, when AutoDist applied one (train() adopts
        # its unroll).
        self.tuned_plan = None
        # run_many's captured programs on the card, for the state they hold
        # the addresses of; whether a step has run eagerly on the card yet.
        self._graphs: Dict[tuple, _CapturedBlock] = {}
        self._graph_state: Optional["TrainState"] = None
        self._graph_pool = None
        self._warm = False
        # The health bundle of the last step (or the last block, reduced): a
        # float32[4] on the device, read by train() at its log boundaries.
        self.health = bool(const.ENV.AUTODIST_HEALTH.val if health is None else health)
        self.last_health = None
        self._health_weights = None
        # Shape signatures built so far (the jit.* counters' key), and
        # whether the graph dumps of AUTODIST_DUMP_GRAPHS were written.
        self._compile_sigs = set()
        self._dumped = False

    # ------------------------------------------------------------------- state
    def init(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """Fresh leaf copies of ``params`` (at their logical shapes) on the
        runner's device, laid out as the plan says (the caller's tensors are
        never updated); the optimizer over the trainable ones (their update
        shards where the update is sharded) in the model spec's order; and
        the codecs' initial state."""
        missing = set(self._model_spec.keys.values()) - set(params)
        if missing:
            raise ValueError(f"params lack {sorted(missing)}")
        placed = {}
        for name, key in self._model_spec.keys.items():
            leaf = params[key].detach().to(self.device, copy=True)
            if self.layout.by_key[key].model_sharded:
                leaf = self.layout.to_storage(key, leaf).clone(
                    memory_format=torch.contiguous_format)
            placed[key] = leaf.requires_grad_(self._model_spec[name].trainable)
        opt_params = {}
        for name in self._model_spec.trainable:
            key = self._model_spec.keys[name]
            opt_params[key] = placed[key]
            if self.layout.by_key[key].sharded_update:
                opt_params[key] = self.layout.to_update(key, placed[key]).detach().clone(
                    memory_format=torch.contiguous_format).requires_grad_()
        optimizer = self._optimizer(list(opt_params.values()))
        if getattr(optimizer, "shard", None) is not None:
            # An optimizer with whole-tensor statistics (the port's
            # Adafactor): each cut tensor reduces them over the ranks
            # holding the other chunks.
            for key, t in opt_params.items():
                ranges, cut = self.layout.update_chunk(key)
                if cut is not None:
                    dim, axes = cut
                    optimizer.shard(t, optimizers.Shard(
                        tuple(self.layout.by_key[key].plan.shape), dim, ranges[dim][0],
                        self.layout.mesh.group(axes)))
        if self.device.type == "cuda":
            # Step counters on the card, in run() and in run_many's graphs
            # alike, so the two make the same optimizer calls.
            for group in optimizer.param_groups:
                if "capturable" in group:
                    group["capturable"] = True
        return TrainState(step=0, params=placed, optimizer=optimizer,
                          ef_state=synchronization.init_compressor_state(
                              self.plan, self._model_spec, self.device),
                          opt_params=opt_params, layout=self.layout)

    def logical_params(self, state_or_params) -> Dict[str, torch.Tensor]:
        """The parameters at their logical shapes (model-axis storage
        gathered and unpadded: a collective, every rank calls it); replicated
        storage comes back as it is stored."""
        params = state_or_params.params if isinstance(state_or_params, TrainState) \
            else state_or_params
        return {k: self.layout.logical(k, v) for k, v in params.items()}

    def _loss_view(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """What the loss reads (:meth:`StateLayout.compute_view`): the
        storage where it is whole or an ``expert``/``pipe`` shard, else
        fresh logical leaves gathered from the model-axis shards."""
        if not self.layout.has_model_storage:
            return state.params
        return {key: self.layout.compute_view(key, t) for key, t in state.params.items()}

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

        rows = {}

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
                rows[micro.shape[0] * micro.shape[1]] = k
                return MicroBatched(place(micro))
            if dp > 1 and t.dim() >= 1 and t.shape[0] % dp == 0:
                t = t[self.plan.batch_rows(t.shape[0], data_index)]
                rows.setdefault(t.shape[0], 1)
            return place(t)

        out = _tree_map(put, batch)
        if not isinstance(out, dict):
            return out
        out = ShardedBatch(out)
        out.rows = rows
        return out

    # -------------------------------------------------------------------- step
    def _accumulate(self, params, batch, ef_state):
        """Micro-gradients summed on this rank and divided by ``k``, then one
        synchronization for the step (every micro-batch's under the explicit
        lowering, whose codecs and residuals step per micro-batch as the JAX
        package's do); the loss is the micro losses' mean. Aux contracts as
        the JAX runner's does (``runner.py:322-356``): a leaf whose second
        stacked dim is the micro-batch's rows folds back to ``[rows, ...]``,
        any other averages over the micro-batches."""
        gsum, losses, auxes = None, [], []
        per_micro = self._grad_fn.explicit
        for i in range(self._accum):
            micro = _tree_map(lambda l: l.value[i] if isinstance(l, MicroBatched) else l,
                              batch)
            if per_micro:
                grads, loss, aux = self._grad_fn(params, micro, ef_state)
            else:
                grads, loss, aux = self._grad_fn.local(params, micro)
            if gsum is None:
                gsum = grads
            else:
                for key, g in grads.items():
                    gsum[key].add_(g)
            losses.append(loss)
            auxes.append(aux)
        grads = {key: g.div_(self._accum) for key, g in gsum.items()}
        loss = torch.stack(losses).mean()
        if not per_micro:
            grads, loss = self._grad_fn.sync(grads, loss, ef_state)
        micro_b = next((l.value.shape[1] for l in _leaves(batch)
                        if isinstance(l, MicroBatched)), None)
        aux = _tree_map(lambda a: a.reshape(-1, *a.shape[2:])
                        if a.dim() >= 2 and a.shape[1] == micro_b else a.mean(0),
                        _stack_trees(auxes)) if self._has_aux else ()
        return grads, loss, aux

    @staticmethod
    def _rows(sharded) -> Mapping[int, int]:
        """:attr:`ShardedBatch.rows` of a laid-out batch (of any other, every
        leading dim, micro-batched leaves folded)."""
        if isinstance(sharded, ShardedBatch):
            return sharded.rows
        rows = {}
        for leaf in _leaves(sharded):
            if isinstance(leaf, MicroBatched):
                rows[leaf.value.shape[0] * leaf.value.shape[1]] = leaf.value.shape[0]
            elif isinstance(leaf, torch.Tensor) and leaf.dim() >= 1:
                rows.setdefault(int(leaf.shape[0]), 1)
        return rows

    def _global(self, tree, rows: Mapping[int, int]):
        """A result computed on this rank's rows as the JAX package returns
        it, computed on the global batch: a leaf whose leading dim is this
        rank's rows is all-gathered over the data ranks in data-major order,
        into the global ``[rows, ...]`` array in the batch's own row order
        (under accumulation each micro-batch's rows gather in turn); any
        other tensor is averaged over the data ranks, which is exact for a
        mean over equal counts."""
        if self._dp_group is None:
            return tree

        def leaf(x):
            if not isinstance(x, torch.Tensor):
                return x
            x = x.detach()
            if x.dim() >= 1 and int(x.shape[0]) in rows:
                chunks = rows[int(x.shape[0])]
                x = x.contiguous()
                out = x.new_empty((self._dp * x.shape[0],) + tuple(x.shape[1:]))
                dist.all_gather_into_tensor(out, x, group=self._dp_group)
                if chunks == 1:
                    return out
                return out.view((self._dp, chunks, -1) + tuple(x.shape[1:])).transpose(
                    0, 1).reshape(out.shape)
            out = x.to(torch.promote_types(x.dtype, torch.float32)).clone()
            dist.all_reduce(out, group=self._dp_group)
            return out / self._dp

        return _tree_map(leaf, tree)

    def run(self, state: TrainState, batch, fetches: Optional[Callable] = None):
        """One synchronized training step; returns ``(state, fetched)``.

        ``fetched`` is the loss, a 0-dim tensor on the device that reading
        waits for (``(loss, aux)`` with ``has_aux``). With ``fetches=fn``,
        ``fn(params, batch)`` runs on the pre-update logical params and this
        rank's rows of the batch (micro-batches folded back) and ``fetched``
        is ``(default, fn_result)``. The loss is the global one; aux and the
        fetched results are made global under data parallelism: a leaf of
        this rank's rows is all-gathered over the data ranks into the global
        ``[rows, ...]`` array, any other leaf averaged over them."""
        with telemetry.span("runner.shard_batch"):
            sharded = self.shard_batch(batch)
        if not self._dumped and const.ENV.AUTODIST_DUMP_GRAPHS.val:
            self._dump_graphs(sharded)
        try:
            with self._dispatch_span("runner.run.dispatch", "step", fetches, sharded):
                loss, aux, extra, bundle = self._step(state, sharded, fetches)
        except Exception as e:  # noqa: BLE001 — OOM forensics, then re-raise
            self._maybe_record_oom("runner.run", e)
            raise
        self._warm = True
        if self.health:
            self.last_health = bundle
        return state, self._fetched(loss, aux, extra, fetches)

    def _fetched(self, loss, aux, extra, fetches):
        default = (loss, aux) if self._has_aux else loss
        return default if fetches is None else (default, extra)

    def _step(self, state: TrainState, sharded, fetches: Optional[Callable]):
        """The step body that :meth:`run` runs and :meth:`run_many` runs K
        times (or captures): ``(loss, aux, fetched, bundle)``, made global;
        ``bundle`` is the health bundle, or None with health off."""
        params = self._loss_view(state)
        if self._accum > 1:
            grads, loss, aux = self._accumulate(params, sharded, state.ef_state)
        else:
            grads, loss, aux = self._grad_fn(params, sharded, state.ef_state)
        extra = None
        if fetches is not None:
            with torch.no_grad(), synchronization.step_mesh(self.mesh):
                extra = _tree_map(
                    lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                    fetches(params, _fold(sharded)))
        bundle = None
        if self.health:
            # The params' norm before the update (the JAX package's
            # convention), and a copy of the tensors the optimizer updates in
            # place, whose change is the update.
            upd_w, par_w, group = self._replication()
            floats = [(k, t) for k, t in state.params.items() if t.is_floating_point()]
            p2 = _health.sq_norm([t for _, t in floats],
                                 None if group is None else [par_w[k] for k, _ in floats],
                                 loss.device)
            keys = list(grads)
            before = torch._foreach_mul([state.opt_params[k].detach() for k in keys], 1.0)
        self._apply_update(state, grads)
        if self.health:
            updates = torch._foreach_sub([state.opt_params[k].detach() for k in keys], before)
            w = None if group is None else [upd_w[k] for k in keys]
            bundle = _health.bundle_of([_health.sq_norm([grads[k] for k in keys], w, loss.device),
                                        _health.sq_norm(updates, w, loss.device), p2],
                                       loss, group)
        rows = self._rows(sharded)
        if self._has_aux:
            aux = self._global(aux, rows)
        if fetches is not None:
            extra = self._global(extra, rows)
        return loss, aux, extra, bundle

    def _replication(self):
        """Per tensor of the bundle's three trees, the number of ranks that
        hold its shard (grads and updates: the optimizer's tensors; params:
        the storage), and the group to sum the partial norms over (None when
        every rank holds every tensor whole)."""
        if self._health_weights is None:
            mesh = self.mesh or single_device_mesh()
            world = self.plan.num_devices
            storage, update = {}, {}
            for key, pl in self.layout.by_key.items():
                storage[key] = mesh.axes_size([a for entry in pl.plan.pspec
                                               for a in entry_axes(entry)])
                update[key] = storage[key] * (mesh.axes_size(pl.update_axes)
                                              if pl.sharded_update else 1)
            group = None
            if world > 1 and any(n > 1 for n in update.values()):
                try:
                    group = mesh.group(tuple(mesh.shape))
                except ValueError:   # a replayed (in-process) mesh has no group
                    group = None
            # graftlint: disable=GL004(a memo of host facts of the plan: built once, at capture as in an eager run, and no replay needs it again)
            self._health_weights = ({k: world / n for k, n in update.items()},
                                    {k: world / n for k, n in storage.items()}, group)
        return self._health_weights

    def _apply_update(self, state: TrainState, grads: Mapping[str, torch.Tensor]) -> None:
        """One optimizer step of ``state`` on ``grads`` (``{key: gradient of
        the optimizer's tensor}``), in place, then the sharded updates
        gathered back into the storage and the step counted."""
        for key, g in grads.items():
            state.opt_params[key].grad = g
        try:
            state.optimizer.step()
        finally:
            for key in grads:
                state.opt_params[key].grad = None
        by_axes: Dict[tuple, list] = {}
        for key in grads:
            pl = self.layout.by_key[key]
            if pl.sharded_update:
                by_axes.setdefault(pl.update_axes, []).append(key)
        for keys in by_axes.values():
            self.layout.gather_updates(keys, state.opt_params, state.params)
        # graftlint: disable=GL004(the host step counter: _capture restores it after the capture, and _CapturedBlock.replay advances it by the block's length on every replay)
        state.step += 1

    # ------------------------------------------------------------ fused steps
    def _place_block_leaf(self, t: torch.Tensor) -> torch.Tensor:
        """A stacked host leaf to the device: one pinned, non-blocking copy."""
        if self.device.type == "cuda" and not t.is_cuda:
            return t.contiguous().pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device, non_blocking=True)

    def shard_block(self, batches, place: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> BatchBlock:
        """K batches stacked into one :class:`BatchBlock` for :meth:`run_many`
        (``runner.py:610-640``): :meth:`shard_batch`'s layout with a leading
        step axis of length K. Leaves are stacked where they are (on the
        host for host batches), then placed once each, by ``place`` (default:
        one pinned, non-blocking copy a leaf on the card); micro-batched
        leaves lay out ``[K, k, B/k, ...]``. Batches that
        :meth:`shard_batch` already laid out stack as they are. Mismatched
        structures and ragged shapes raise ``ValueError``."""
        batches = list(batches)
        if not batches:
            raise ValueError("shard_block needs at least one batch")
        first = _structure(batches[0])
        for i, b in enumerate(batches[1:], 1):
            if _structure(b) != first:
                raise ValueError(
                    f"shard_block: batch {i}'s structure {_structure(b)} does not match "
                    f"batch 0's {first}; a block runs one captured step over "
                    f"uniformly-shaped batches")
        K = len(batches)
        place = place or self._place_block_leaf

        def stacked(leaves):
            ts = [torch.as_tensor(l) for l in leaves]
            shapes = sorted({tuple(t.shape) for t in ts})
            if len(shapes) > 1:
                raise ValueError(
                    f"shard_block: batches disagree on a leaf's shape {shapes}; a block "
                    f"runs one captured step over uniformly-shaped batches: pad the "
                    f"ragged batch (or use unroll=1 / per-step run() for shape-bucketed "
                    f"data)")
            device = next((t.device for t in ts if t.device.type != "cpu"), None)
            return torch.stack([t.to(device) for t in ts] if device is not None else ts)

        if all(isinstance(b, ShardedBatch) for b in batches):
            tree = _tree_map(lambda *ls: MicroBatched(stacked([l.value for l in ls]))
                              if isinstance(ls[0], MicroBatched) else stacked(ls), *batches)
            return BatchBlock(tree, K, batches[0].rows)
        k, dp, data_index = self._accum, self._dp, self._data_index
        folded = [_fold(b) for b in batches]
        batch_dim = 0
        if k > 1:
            dims = self._leading_dims(folded[0])
            batch_dim = self._infer_batch_dim(dims, k * dp)
            if batch_dim not in dims:
                raise ValueError(
                    f"batch_size={batch_dim} matches no leaf's leading dim (present: "
                    f"{sorted(dims)}); nothing would be micro-split for "
                    f"accumulation_steps={k}")
        rows: Dict[int, int] = {}

        def put(*leaves):
            t = stacked(leaves)
            shape = tuple(t.shape[1:])
            if k > 1 and len(shape) >= 1 and shape[0] == batch_dim:
                if shape[0] % (k * dp):
                    raise ValueError(
                        f"Global batch {shape[0]} is not divisible into "
                        f"accumulation_steps={k} micro-batches over {dp} data "
                        f"replicas; make it divisible by {k * dp}")
                micro = t.reshape(K, k, shape[0] // k, *shape[1:])
                if dp > 1:
                    micro = micro[:, :, self.plan.batch_rows(micro.shape[2], data_index)]
                rows[micro.shape[1] * micro.shape[2]] = k
                return MicroBatched(place(micro))
            if dp > 1 and len(shape) >= 1 and shape[0] % dp == 0:
                t = t[:, self.plan.batch_rows(shape[0], data_index)]
                rows.setdefault(t.shape[1], 1)
            return place(t)

        tree = _tree_map(put, *folded)
        return BatchBlock(tree, K, rows)

    def run_many(self, state: TrainState, batches, fetches: Optional[Callable] = None):
        """K synchronized training steps as one dispatch; returns ``(state,
        fetched)`` (``runner.py:982-1024``).

        ``batches`` is a sequence of K batches or a :class:`BatchBlock`
        (:meth:`shard_block`, ``prefetch_to_device(..., unroll=K)``). The
        result equals K :meth:`run` calls bit for bit. ``fetched`` is
        :meth:`run`'s with a leading ``[K]`` step axis: the losses as a
        ``[K]`` stack, aux and ``fetches=fn`` results stacked per step (each
        from that step's pre-update params). On a CUDA device the K steps
        are one captured graph (see the module docstring); a plan that
        cannot be captured raises ``RuntimeError`` naming the cause."""
        if isinstance(batches, BatchBlock):
            block = batches
        else:
            with telemetry.span("runner.shard_block"):
                block = self.shard_block(batches)
        try:
            with self._dispatch_span("runner.run_many.dispatch", "many", fetches, block.tree,
                                     steps=block.length):
                if self.device.type == "cuda":
                    out = self._run_graphed(state, block, fetches)
                else:
                    out = self._stacked([self._step(state, block.step(i), fetches)
                                         for i in range(block.length)], fetches)
        except Exception as e:  # noqa: BLE001 — OOM forensics, then re-raise
            self._maybe_record_oom("runner.run_many", e)
            raise
        losses, aux, extra, bundle = out
        if self.health:
            self.last_health = bundle
        return state, self._fetched(losses, aux, extra, fetches)

    def _stacked(self, outs, fetches):
        """The K steps' outputs stacked; their health bundles reduced on the
        device (:func:`autodist_tpu_torch.telemetry.health.reduce_bundle`)."""
        losses = torch.stack([o[0] for o in outs])
        aux = _stack_trees([o[1] for o in outs]) if self._has_aux else ()
        extra = _stack_trees([o[2] for o in outs]) if fetches is not None else None
        bundle = _health.reduce_bundle(torch.stack([o[3] for o in outs])) \
            if self.health else None
        return losses, aux, extra, bundle

    def _run_graphed(self, state: TrainState, block: BatchBlock, fetches):
        """The block through its captured graph: captured first where none
        holds this (K, fetches, health, signature) for this state and these optimizer
        settings, after an eager warm-up on a side stream when no step has run
        on the card yet (that block's steps are the warm-up's)."""
        if self._graph_state is not state:
            self._graphs.clear()
            self._graph_state = state
        key = (block.length, fetches, self.health, _signature(block.tree))
        hyper = _hyperparameters(state.optimizer)
        graph = self._graphs.get(key)
        if graph is not None and graph.hyper == hyper:
            return graph.replay(state, block)
        warmed = None
        if not self._warm:
            warmed = self._warm_up(state, block, fetches)
        graph = self._graphs[key] = self._capture(state, block, fetches, hyper)
        return warmed if warmed is not None else graph.replay(state, block)

    def _warm_up(self, state: TrainState, block: BatchBlock, fetches):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._stacked([self._step(state, block.step(i), fetches)
                                 for i in range(block.length)], fetches)
        current.wait_stream(side)
        for t in _leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(current)
        self._warm = True
        return out

    def _capture(self, state: TrainState, block: BatchBlock, fetches, hyper) -> _CapturedBlock:
        static_tree = _tree_map(
            lambda l: MicroBatched(l.value.clone()) if isinstance(l, MicroBatched)
            else l.clone() if isinstance(l, torch.Tensor) else l, block.tree)
        static = BatchBlock(static_tree, block.length, block.rows)
        before = _state_tensors(state)
        step0 = state.step
        graph = torch.cuda.CUDAGraph()
        if self._graph_pool is None:
            # One memory pool for every graph of the runner: they replay one
            # at a time on one stream, and each replay's outputs are cloned
            # before the next, so one step's temporaries serve them all.
            self._graph_pool = torch.cuda.graph_pool_handle()
        try:
            with costs.recorded_launches() as launches:
                with torch.cuda.graph(graph, pool=self._graph_pool):
                    outputs = self._stacked([self._step(state, static.step(i), fetches)
                                             for i in range(static.length)], fetches)
        except Exception as e:  # noqa: BLE001 — named, then raised
            raise RuntimeError(
                f"run_many: this plan cannot be captured into a CUDA graph, so it has no "
                f"fused {block.length}-step program on the card ({type(e).__name__}: "
                f"{e}); run it per step: run(), or train(..., unroll=1)") from e
        finally:
            state.step = step0
        rebound = [name for name, t in _state_tensors(state).items() if before.get(name) is not t]
        if rebound:
            raise RuntimeError(
                f"run_many: the step replaced state tensors {rebound[:4]} instead of "
                f"updating them in place, so a captured graph cannot replay it; run it "
                f"per step: run(), or train(..., unroll=1)")
        _GRAPHED.add(self)
        return _CapturedBlock(graph, static_tree, outputs, dict(launches), hyper)

    def release_graphs(self) -> None:
        """Drop ``run_many``'s captured graphs and their memory pool, once
        the card has finished every replay; the next block captures anew. A
        graph captured with NCCL collectives inside (the gradient all-reduce,
        Adafactor's statistics) holds their communicator, and NCCL's destroy
        waits until every such graph is freed: :func:`shutdown` calls this on
        every runner before it destroys the process group."""
        if not self._graphs and self._graph_pool is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for block in self._graphs.values():
            block.graph.reset()
        self._graphs.clear()
        self._graph_state = None
        self._graph_pool = None
        if self.device.type == "cuda":
            # Freed graphs release their hold on the communicators once the
            # card is done with them.
            torch.cuda.synchronize(self.device)
        _GRAPHED.discard(self)

    # --------------------------------------------------------------- cost probe
    def plan_costs(self, params, example_batch, unroll: int = 1) -> Optional[dict]:
        """Static cost probe of this runner's step (``runner.py:892-932``):
        ``{"flops", "bytes_accessed", "steps", "dispatches", "launches",
        "source"}`` per dispatch, the record
        :func:`autodist_tpu_torch.telemetry.costmodel.predict` prices, or None
        when the step does not trace. **No step executes and nothing is
        allocated on the card**: the loss and its gradient are traced on
        fake CPU tensors of ``params``' and ``example_batch``'s shapes (this
        rank's rows of one micro-batch, counted ``k`` times, with the
        accumulation's adds), and the optimizer's update on meta tensors.
        The kernel wrappers count their kernels' HBM bytes, operations and
        launches in place of their plain versions'. ``launches`` counts the
        ATen ops of one eager step that launch work on the card, each a host
        dispatch (one op may launch several kernels); ``unroll=K`` describes
        a K-step graph, one replay (``launches`` 1) doing K steps' work."""
        if unroll < 1:
            raise ValueError("unroll must be >= 1")
        missing = set(self._model_spec.keys.values()) - set(params)
        if missing:
            raise ValueError(f"params lack {sorted(missing)}")
        try:
            cost = self._step_cost(example_batch)
        except Exception as e:  # noqa: BLE001 — a probe that cannot trace reports nothing
            _log.warning("plan_costs: the step did not trace (%s: %s); no cost",
                         type(e).__name__, e)
            return None
        if unroll > 1:
            return {"flops": cost["flops"] * unroll,
                    "bytes_accessed": cost["bytes_accessed"] * unroll,
                    "steps": unroll, "dispatches": 1, "launches": 1, "source": "fake-trace"}
        return dict(cost, steps=1, dispatches=1, source="fake-trace")

    def _step_cost(self, example_batch, split: Optional[int] = None) -> Dict[str, Any]:
        """One step's cost on ``example_batch``: the global batch, whose
        leading batch dim is split ``k * dp`` ways to one micro-batch of this
        rank, or ``split`` ways (``k`` for a batch already laid out)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        k, dp = self._accum, self._dp
        split = k * dp if split is None else split
        host = _tree_map(lambda l: torch.as_tensor(l) if isinstance(l, np.ndarray) else l,
                         _fold(example_batch))
        batch_dim = None
        if split > 1:
            batch_dim = self._infer_batch_dim(self._leading_dims(host), split)
            if split != k * dp and self._batch_size is not None:
                batch_dim = self._batch_size // dp   # batch_size= is global
        trainable = {self._model_spec.keys[n] for n in self._model_spec.trainable}

        def fake(t):
            if not isinstance(t, torch.Tensor):
                return t
            shape = tuple(t.shape)
            if batch_dim and shape and shape[0] == batch_dim:
                shape = (batch_dim // split,) + shape[1:]
            return torch.empty(shape, dtype=t.dtype)

        with FakeTensorMode():
            params = {key: torch.empty(self._compute_shape(name, key),
                                       dtype=self._model_spec[name].dtype)
                      .requires_grad_(key in trainable)
                      for name, key in self._model_spec.keys.items()}
            batch = _tree_map(fake, host)
            with costs.StepCost() as micro:
                grads, _, _ = self._grad_fn.local(params, batch)
            grad_bytes = sum(g.numel() * g.element_size() for g in grads.values())
        flops = micro.flops * k
        nbytes = micro.bytes_accessed * k
        launches = micro.launches * k
        if k > 1:   # the micro-gradients' sum, its division and the losses' mean
            nbytes += 3 * grad_bytes * (k - 1) + 2 * grad_bytes
            launches += len(grads) * k + 2
        update = self._update_cost()
        return {"flops": flops + update.flops,
                "bytes_accessed": nbytes + update.bytes_accessed,
                "launches": launches + update.launches}

    def _update_cost(self):
        """The optimizer's update, counted on meta tensors of the trainable
        parameters' shapes (its second step: the first creates its state),
        with the card's default implementation (``foreach``). An optimizer
        that cannot step on meta tensors is counted as nothing."""
        metas = [torch.empty(p.shape, dtype=p.dtype, device="meta", requires_grad=True)
                 for p in self._model_spec.trainable.values()]
        optimizer = self._optimizer(metas)
        if self.device.type == "cuda":
            for group in optimizer.param_groups:
                if "foreach" in group and group["foreach"] is None:
                    group["foreach"] = True
        for p in metas:
            p.grad = torch.empty_like(p)
        cost = costs.StepCost()
        try:
            optimizer.step()
            with cost:
                optimizer.step()
        except Exception as e:  # noqa: BLE001 — an optimizer with host reads does not run on meta
            _log.info("plan_costs: %s does not step on meta tensors (%s); its update is "
                      "not counted", type(optimizer).__name__, e)
            return costs.StepCost()
        return cost

    # ----------------------------------------------------------- telemetry
    @staticmethod
    def _compile_signature(kind: str, fetches, batch) -> str:
        """A dispatch's shape signature: kind, fetch fn, and every leaf's
        dtype and shape (``runner.py:708-722``); a new one is a build."""
        parts = [kind, "none" if fetches is None else f"id{id(fetches)}",
                 str(_structure(batch))]
        for leaf in _leaves(batch):
            v = leaf.value if isinstance(leaf, MicroBatched) else leaf
            parts.append(f"{'m' if isinstance(leaf, MicroBatched) else ''}"
                         f"{getattr(v, 'dtype', type(v).__name__)}"
                         f"{tuple(getattr(v, 'shape', ()))}")
        return "|".join(parts)

    def _dispatch_span(self, name: str, kind: str, fetches, batch, steps: int = 1):
        """The span around a dispatch (``runner.py:798-835``). Telemetry on:
        the dispatch counts against its signature's program-cost record, and
        the first dispatch of a new signature becomes a ``jit.compile`` span
        (a crc32 of the signature) booking ``jit.cache_miss`` and
        ``jit.compile_s``, and with the attribution plane on, recording the
        signature's ``plan_costs`` (its first step: ``batch`` of a block
        carries a leading step axis), and on a card booking the dispatch's
        device time (``profiling.device_timed``). Off: the shared no-op
        span."""
        if not telemetry.enabled():
            return telemetry.span(name)
        sig = self._compile_signature(kind, fetches, batch)
        digest = format(zlib.crc32(sig.encode()), "08x")
        _profiling.note_dispatch(digest, kind, steps)
        span_args = {"steps": steps} if kind == "many" else {}
        if sig in self._compile_sigs:
            return _profiling.device_timed(telemetry.span(name, **span_args), self.device)
        self._compile_sigs.add(sig)
        cost_cb = None
        if _profiling.active():
            def cost_cb(compile_s):
                step_batch = _tree_map(
                    lambda l: MicroBatched(l.value[0]) if isinstance(l, MicroBatched)
                    else l[0] if isinstance(l, torch.Tensor) else l, batch) \
                    if kind == "many" else batch
                _profiling.record_program_cost(digest, kind, steps,
                                               self._program_cost(step_batch, steps),
                                               compile_s=compile_s)
        return _profiling.device_timed(
            _CompileProbe(telemetry.span("jit.compile", kind=kind, sig=digest, **span_args),
                          cost_cb), self.device)

    def _program_cost(self, sharded, steps: int) -> Optional[Dict[str, Any]]:
        """``plan_costs`` of a dispatch of ``steps`` steps on a laid-out
        batch (one step's), for the attribution plane's record."""
        try:
            cost = self._step_cost(sharded, split=self._accum)
        except Exception as e:  # noqa: BLE001 — accounting never breaks a step
            _log.debug("program cost: the step did not trace (%s)", e)
            return None
        return {"flops": cost["flops"] * steps,
                "bytes_accessed": cost["bytes_accessed"] * steps,
                "output_bytes": None, "source": "fake-trace"}

    @staticmethod
    def _maybe_record_oom(where: str, exc: BaseException) -> None:
        """OOM forensics at the dispatch sites (``runner.py:783-796``): a
        step that died of ``torch.cuda.OutOfMemoryError`` books ``mem.oom``
        and triggers the flight recorder; the caller re-raises either way."""
        try:
            from autodist_tpu_torch.telemetry import memplane as _memplane
            if _memplane.is_oom_error(exc):
                _memplane.record_oom(where, exc)
        except Exception:  # noqa: BLE001 — diagnostics must never mask
            pass

    def _dump_graphs(self, sharded) -> None:
        """``AUTODIST_DUMP_GRAPHS`` (``runner.py:1066-1081``): the FX graphs
        of the user's loss (``0-original``) and of the step, gradient and
        update (``1-distributed``), traced on fake tensors of this rank's
        shapes (one micro-batch), so the state is untouched."""
        from autodist_tpu_torch.utils import tracing
        self._dumped = True
        micro = _tree_map(lambda l: l.value[0] if isinstance(l, MicroBatched) else l, sharded)
        shapes = {key: torch.empty(self._compute_shape(name, key),
                                   dtype=self._model_spec[name].dtype, device="meta")
                  .requires_grad_(name in self._model_spec.trainable)
                  for name, key in self._model_spec.keys.items()}
        trainable = [self._model_spec.keys[n] for n in self._model_spec.trainable]
        tracing.dump_stage("train_step", "0-original", self._loss_fn, shapes, dict(micro))

        def step(params, batch):
            grads, loss, _ = self._grad_fn.local(params, batch)
            optimizer = self._optimizer([params[k] for k in trainable])
            for k in trainable:
                params[k].grad = grads[k]
            optimizer.step()
            return loss, [params[k] for k in trainable]

        tracing.dump_stage("train_step", "1-distributed", step, shapes, dict(micro))

    def _compute_shape(self, name: str, key: str) -> tuple:
        """What the loss reads of a parameter: its logical shape, or the
        local shard of an ``expert``/``pipe`` parameter."""
        pl = self.layout.by_key[key]
        if pl.compute_local:
            return tuple(sl.stop - sl.start for sl in pl.storage)
        return tuple(self._model_spec[name].shape)

    def evaluate(self, state: TrainState, batch, fn: Optional[Callable] = None):
        """``fn(params, batch)`` (default: the loss) on the logical params and
        this rank's rows, without gradients or an update; ``state`` is left
        as it is. A 0-dim floating result is averaged over the data and seq
        ranks, as the training loss is, so it is the global value; any other
        result is made global as :meth:`run` makes aux global."""
        fn = fn if fn is not None else self._loss_fn
        if isinstance(batch, ShardedBatch):
            rows, batch = batch.rows, ShardedBatch(_fold(batch))
            batch.rows = rows
        else:
            batch = self.shard_batch(_fold(batch), accumulation=1)
        with torch.no_grad(), synchronization.step_mesh(self.mesh):
            out = fn(self._loss_view(state), batch)
        group = self.mesh.group(synchronization.SYNC_AXES)
        if isinstance(out, torch.Tensor) and out.dim() == 0 and out.is_floating_point():
            if group is not None:
                out = out.clone()
                dist.all_reduce(out, group=group)
                out = out / dist.get_world_size(group)
            return out
        return self._global(out, self._rows(batch))


def shutdown() -> None:
    """The end of a distributed entry point: every runner's captured graphs
    released (:meth:`DistributedRunner.release_graphs`), then the default
    process group destroyed. Destroying it first hangs on the cards: NCCL
    waits for the graphs that hold its communicators, which the process
    would free only after the destroy returns."""
    for runner in list(_GRAPHED):
        runner.release_graphs()
    if dist.is_initialized():
        dist.destroy_process_group()


def step_function(runner: DistributedRunner, params: Dict[str, torch.Tensor]) -> Callable:
    """``step(batch, fetches=None)`` over ``runner``, returning what
    :meth:`DistributedRunner.run` fetches and carrying the training state
    inside, started from ``params``; ``step.runner``, ``step.get_state()``
    and ``step.evaluate(batch, fn=None)`` expose it (what
    ``AutoDist.function`` returns)."""
    state = runner.init(params)

    def step(batch, fetches=None):
        # The synchronous runner returns the state it was given; the async
        # one its service's current state.
        nonlocal state
        state, fetched = runner.run(state, batch, fetches=fetches)
        return fetched

    step.runner = runner
    step.get_state = lambda: state
    step.evaluate = lambda batch, fn=None: runner.evaluate(state, batch, fn)
    return step
