"""Host-driven async / bounded-staleness execution (the port's copy of
``autodist_tpu/parallel/staleness.py``).

The reference's PS synchronizer had three regimes: synchronous, bounded
staleness (token queues of size ``staleness`` letting a fast worker run
ahead) and fully async (``sync=False``, each worker's gradient applied as it
arrives). The two non-synchronous ones are a host-driven loop:

- :class:`ParameterService` owns the train state and applies one worker's
  gradient at a time: the PS apply.
- :class:`StalenessController` gates workers on their completed-step
  counts: a worker may start a step only while ``its_steps - min(all_steps)
  < staleness`` (unbounded when ``staleness == 0`` under ``sync=False``).
- :class:`AsyncPSRunner` gives each logical worker a handle whose
  ``step(batch)`` reads the current parameters, computes gradients and
  pushes them.

**Snapshots.** The JAX package's service hands out immutable arrays, so a
stale worker computes on the version it read. ``torch.optim`` updates its
tensors in place, so here the service keeps the optimizer's own tensors
private and, after every apply, publishes the new version as fresh tensors
(``_publish``): a version a worker holds is never written again. Readers
share one snapshot a version (one clone an apply, not one a read).

**Ordering on the card.** A worker's gradients are complete on the device
(its stream synchronized) before the apply reads them, and the apply is
complete before the next program starts: gradient and apply programs run
one at a time under the runner's ``_collective_lock``, as the JAX package's
``block_until_ready`` does. A worker thread runs under its runner's card
(``torch.cuda.device``), since the current device is per thread.
"""

import contextlib
import logging
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.parallel.mesh import single_device_mesh
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.runner import DistributedRunner, TrainState
from autodist_tpu_torch.telemetry.metrics import COUNT_BUCKETS, Histogram
from autodist_tpu_torch.testing import faults as _faults

_log = logging.getLogger("autodist_tpu_torch")

# Default server-side apply shard count when ZeRO is requested without an
# explicit count (AUTODIST_ZERO=1 / zero=1).
DEFAULT_PS_SHARDS = 4


_STALENESS_TEL = None


def _staleness_registry_hist():
    """The process-wide ``ps.staleness`` registry histogram, None while
    telemetry is off (one enabled check a gate entry)."""
    if not telemetry.enabled():
        return None
    global _STALENESS_TEL
    if _STALENESS_TEL is None:
        _STALENESS_TEL = telemetry.histogram("ps.staleness", COUNT_BUCKETS)
    return _STALENESS_TEL


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _assign_shards(named: Dict[str, torch.Tensor], shards: int) -> List[List[str]]:
    """Partition names into ``<= shards`` balanced groups (greedy largest
    first by byte size; ties break by name)."""
    shards = max(1, min(int(shards), len(named)) if named else 1)
    sized = sorted(named.items(), key=lambda kv: (-_nbytes(kv[1]), kv[0]))
    bins: List[List[str]] = [[] for _ in range(shards)]
    loads = [0] * shards
    for name, leaf in sized:
        s = loads.index(min(loads))
        bins[s].append(name)
        loads[s] += _nbytes(leaf) or 1
    return [sorted(b) for b in bins if b]


def _publish(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A version's parameters as readers get them: fresh copies of the
    trainable tensors (leaves that require grad, as the loss wants them),
    which nothing writes again; the others as they are (never updated)."""
    with torch.no_grad():
        return {k: t.detach().clone().requires_grad_() if t.requires_grad else t
                for k, t in params.items()}


def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class StalenessTimeout(TimeoutError):
    """A gated worker step did not become runnable within the timeout."""


class WorkerEvicted(RuntimeError):
    """The worker was retired from the staleness gate while (or before)
    waiting to step. :class:`~autodist_tpu_torch.parallel.ps_transport.RemotePSWorker`
    reacts by re-registering and catching up on the chief's live params."""


# Largest jump past the gate's size one register() may request.
_MAX_SLOT_GROWTH = 4096


class StalenessController:
    """Bounded-staleness gate over per-worker completed-step counts: with
    bound ``s`` a worker completes exactly ``s`` more steps than the slowest
    live worker before its next ``start_step`` blocks; ``staleness=0`` is
    unbounded."""

    def __init__(self, num_workers: int, staleness: int = 0):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self._bound = staleness if staleness > 0 else math.inf
        self._steps = [0] * num_workers
        self._retired = set()
        # Per-worker lag at every gate entry (the stats opcode's payload).
        self._lag_hists: Dict[int, Histogram] = {}
        self._max_lag = 0
        # Per-slot occupancy generation, bumped by register(): a disconnect
        # handler that saw an old occupant retires only that occupant.
        self._generation: dict = {}
        self._cond = threading.Condition()   # RLock-backed

    @property
    def steps(self):
        with self._cond:
            return list(self._steps)

    @property
    def bound(self):
        """The staleness bound (``math.inf`` when unbounded)."""
        return self._bound

    def live_lags(self) -> Dict[int, int]:
        """Per live worker, its completed steps ahead of the slowest live one."""
        with self._cond:
            live = {i: s for i, s in enumerate(self._steps) if i not in self._retired}
        if not live:
            return {}
        slowest = min(live.values())
        return {i: s - slowest for i, s in live.items()}

    def _runnable(self, worker_id: int) -> bool:
        live = [s for i, s in enumerate(self._steps) if i not in self._retired]
        return not live or self._steps[worker_id] - min(live) < self._bound

    def generation(self, worker_id: int) -> int:
        with self._cond:
            return self._generation.get(worker_id, 0)

    def slot_state(self, worker_id: Optional[int]) -> str:
        """``"live"``, ``"retired"`` or ``"new"`` (never allocated, or None)."""
        with self._cond:
            if worker_id is None or worker_id < 0 or worker_id >= len(self._steps):
                return "new"
            return "retired" if worker_id in self._retired else "live"

    def retire(self, worker_id: int, generation: Optional[int] = None) -> bool:
        """Remove a dead worker from the gate (its frozen count would pin
        ``min(steps)``). With ``generation``, only if the slot's occupancy
        generation still matches. True only when a live worker was retired."""
        with self._cond:
            if generation is not None and generation != self._generation.get(worker_id, 0):
                _log.info("Ignoring stale retire of worker %d (generation %d != current %d)",
                          worker_id, generation, self._generation.get(worker_id, 0))
                return False
            if worker_id in self._retired:
                return False
            self._retired.add(worker_id)
            self._cond.notify_all()
            return True

    def register(self, worker_id: Optional[int] = None) -> int:
        """Admit a worker mid-run (a replacement, or ``None`` for the next
        id); returns its id. A live slot keeps its count (an idempotent
        retry) but bumps its generation. A new or retired slot is seeded at
        the slowest live worker's count."""
        with self._cond:
            if worker_id is not None and worker_id < 0:
                raise ValueError(f"worker_id must be >= 0, got {worker_id}")
            if worker_id is not None and worker_id > len(self._steps) + _MAX_SLOT_GROWTH:
                raise ValueError(
                    f"worker_id {worker_id} is beyond the gate's current "
                    f"{len(self._steps)} slot(s) + growth margin {_MAX_SLOT_GROWTH}; "
                    f"register sequentially or pass None to allocate the next id")
            if worker_id is not None and worker_id < len(self._steps) \
                    and worker_id not in self._retired:
                self._generation[worker_id] = self._generation.get(worker_id, 0) + 1
                return worker_id
            if worker_id is None:
                worker_id = len(self._steps)
            while worker_id >= len(self._steps):
                # Intermediate brand-new slots stay retired until registered.
                self._steps.append(0)
                self._retired.add(len(self._steps) - 1)
            self._retired.discard(worker_id)
            self._generation[worker_id] = self._generation.get(worker_id, 0) + 1
            live = [s for i, s in enumerate(self._steps)
                    if i not in self._retired and i != worker_id]
            if live:
                self._steps[worker_id] = min(live)
            self._cond.notify_all()
            return worker_id

    def register_with_generation(self, worker_id: Optional[int] = None):
        """:meth:`register` and the slot's resulting generation, read in the
        same critical section."""
        with self._cond:
            wid = self.register(worker_id)
            return wid, self._generation.get(wid, 0)

    def start_step(self, worker_id: int, timeout: Optional[float] = None) -> int:
        """Block until the worker is within the bound; returns the slot's
        generation. Raises :class:`StalenessTimeout` after ``timeout``
        seconds, and :class:`WorkerEvicted` when the worker is retired while
        (or before) it waits."""
        with self._cond:
            live = [s for i, s in enumerate(self._steps) if i not in self._retired]
            lag = self._steps[worker_id] - min(live) if live else 0
            hist = self._lag_hists.get(worker_id)
            if hist is None:
                hist = self._lag_hists[worker_id] = Histogram(
                    f"ps.staleness.worker{worker_id}", COUNT_BUCKETS)
            hist.observe(lag)
            tel = _staleness_registry_hist()
            if tel is not None:
                tel.observe(lag)
            self._max_lag = max(self._max_lag, lag)
            with telemetry.span("ps.gate_wait", worker=worker_id):
                runnable = self._cond.wait_for(
                    lambda: worker_id in self._retired or self._runnable(worker_id), timeout)
            if not runnable:
                raise StalenessTimeout(
                    f"worker {worker_id} at step {self._steps[worker_id]} still >= "
                    f"{self._bound} ahead of the slowest worker after {timeout}s")
            if worker_id in self._retired:
                raise WorkerEvicted(f"worker {worker_id} was retired from the staleness gate "
                                    f"(evicted or disconnected); re-register to rejoin")
            return self._generation.get(worker_id, 0)

    def finish_step(self, worker_id: int) -> int:
        """Advance the worker's completed-step count; returns its generation."""
        with self._cond:
            self._steps[worker_id] += 1
            self._cond.notify_all()
            return self._generation.get(worker_id, 0)

    def staleness_histograms(self) -> Dict[int, Histogram]:
        with self._cond:
            return dict(sorted(self._lag_hists.items()))

    def staleness_snapshot(self) -> Dict[int, Dict]:
        """``{worker_id: histogram snapshot}``, the stats opcode's staleness half."""
        with self._cond:
            hists = dict(self._lag_hists)
        return {wid: h.snapshot() for wid, h in sorted(hists.items())}

    def max_lag(self) -> int:
        """The largest lag any gate entry found (0 before any)."""
        with self._cond:
            return self._max_lag


class ParameterService:
    """The PS: owns the train state and serializes gradient application.

    ``apply_fn(state, grads)`` steps the state's optimizer in place and
    returns it; after it the new version is published (:func:`_publish`).
    ``read``/``read_if_newer``/``read_min`` return ``(params, ef_state,
    version)`` of the published version, one lock hold a read."""

    def __init__(self, state: TrainState, apply_fn: Optional[Callable]):
        self._state = state
        self._apply_fn = apply_fn
        self._params = _publish(state.params)
        # Readers wait on it (read_min); every state change notifies.
        self._lock = threading.Condition()
        # Serializes writers (apply/reset/adopt), so readers block for the
        # brief state swap, not for a whole apply. Order: _write_mutex ->
        # _lock, never the reverse — declared so an inverted path fails lint
        # (GL002) instead of deadlocking a chief under load.
        # graftlint: lock-order=_write_mutex->_lock
        self._write_mutex = threading.Lock()
        # Bumps on every state change and is never reused: version equality
        # implies identity (read_if_newer's "not modified").
        self._version = 0
        self._updates = 0

    def reset(self, state: TrainState):
        """Replace the state (checkpoint restore): the update count restarts,
        the version keeps counting."""
        with self._write_mutex:
            params = _publish(state.params)
            with self._lock:
                self._state, self._params = state, params
                self._version += 1
                self._updates = 0
                self._lock.notify_all()

    @property
    def version(self) -> int:
        return self._version

    @property
    def state(self) -> TrainState:
        return self._state

    def read(self):
        with self._lock:
            return self._params, self._state.ef_state, self._version

    def read_if_newer(self, version: int):
        """:meth:`read` when the service has moved past ``version``, else
        ``(None, None, version)``."""
        with self._lock:
            if self._version == version:
                return None, None, self._version
            return self._params, self._state.ef_state, self._version

    def read_min(self, min_version: int, have_version: int, timeout: Optional[float] = None):
        """:meth:`read_if_newer` after waiting (up to ``timeout``) for the
        service to reach ``min_version``; on timeout the current state."""
        with self._lock:
            self._lock.wait_for(lambda: self._version >= min_version, timeout)
            if self._version == have_version:
                return None, None, self._version
            return self._params, self._state.ef_state, self._version

    def apply(self, grads: Dict[str, torch.Tensor]) -> int:
        """Apply one worker's gradients; returns the new version. Readers
        keep reading the previous version until the new one is published."""
        with self._write_mutex:
            with telemetry.span("ps.apply"):
                state = self._apply_fn(self._state, grads)
                params = _publish(state.params)
            with self._lock:
                self._state, self._params = state, params
                self._version += 1
                self._updates += 1
                self._lock.notify_all()
                return self._version

    @property
    def updates_applied(self) -> int:
        return self._updates

    def adopt(self, state: TrainState, place_fn) -> None:
        """Adopt a foreign state iff no update has been applied yet (the
        checkpoint-restore pattern), atomically against concurrent applies."""
        with self._write_mutex:
            if state is self._state:
                return
            if self._updates != 0:
                raise RuntimeError(
                    "AsyncPSRunner.run was handed a state that is not the service's current "
                    "state after updates were already applied; use restore(state) to adopt a "
                    "checkpoint explicitly")
            placed = place_fn(state)
            params = _publish(placed.params)
            with self._lock:
                self._state, self._params = placed, params
                self._version += 1
                self._lock.notify_all()

    def close(self):
        pass


class ShardedParameterService(ParameterService):
    """ZeRO-style sharded PS apply: each worker's update is applied over S
    concurrent shards of the trainable parameters (balanced by bytes), each
    with its own mutex, its own optimizer over its parameters (made by the
    runner's factory at the shard's first apply, from the whole-tree
    optimizer's state, so a checkpoint loaded before it counts) and its own
    version counter. Reads are shard-grained; the aggregate version bumps
    once a shard apply. The ``state`` property assembles a whole-tree
    optimizer (the shards' state, shared, not copied) so checkpoints save
    unsharded. Exact for elementwise optimizers (SGD, Adam)."""

    def __init__(self, state: TrainState, optimizer_factory: Callable, shards: int,
                 exec_fn: Callable, capturable: bool = False):
        super().__init__(state, apply_fn=None)
        self._factory = optimizer_factory
        self._exec = exec_fn
        self._capturable = capturable
        self._assign = _assign_shards(dict(state.opt_params), shards)
        self.shards = len(self._assign)
        self._shard_mutex = [threading.Lock() for _ in self._assign]
        self._shard_version = [0] * self.shards
        self._shard_opt: List[Optional[torch.optim.Optimizer]] = [None] * self.shards
        self._assembled: Optional[TrainState] = None
        self._assembled_version = -1
        self._flat = dict(self._params)
        self._params_version = self._version
        self._inflight = 0
        self._pool = ThreadPoolExecutor(max_workers=self.shards,
                                        thread_name_prefix="ps-shard-apply")
        _log.info("ShardedParameterService: %d apply shard(s) over %d parameters",
                  self.shards, len(state.opt_params))

    @property
    def shard_versions(self) -> List[int]:
        with self._lock:
            return list(self._shard_version)

    def _optimizer(self, tensors: List[torch.Tensor]) -> torch.optim.Optimizer:
        opt = self._factory(tensors)
        if self._capturable:
            for group in opt.param_groups:
                if "capturable" in group:
                    group["capturable"] = True
        return opt

    def _shard_optimizer(self, s: int) -> torch.optim.Optimizer:
        """Shard ``s``'s optimizer (callers hold its mutex), made at first use
        from the whole-tree optimizer's state of its parameters."""
        opt = self._shard_opt[s]
        if opt is None:
            tensors = [self._state.opt_params[n] for n in self._assign[s]]
            opt = self._optimizer(tensors)
            whole = self._state.optimizer.state
            for t in tensors:
                if t in whole:
                    opt.state[t] = whole[t]
            self._shard_opt[s] = opt
        return opt

    def _apply_one_shard(self, s: int, grads: Dict[str, torch.Tensor]):
        names = self._assign[s]
        with self._shard_mutex[s]:
            opt = self._shard_optimizer(s)
            tensors = self._state.opt_params

            def run():
                for n in names:
                    tensors[n].grad = grads[n].to(tensors[n].device)
                try:
                    opt.step()
                finally:
                    for n in names:
                        tensors[n].grad = None
                return _publish({n: tensors[n] for n in names})

            with telemetry.span("ps.apply", shard=s, shards=self.shards):
                published = self._exec(run)
            with self._lock:
                self._flat.update(published)
                self._shard_version[s] += 1
                self._version += 1
                self._lock.notify_all()
                if telemetry.enabled():
                    telemetry.gauge(f"ps.shard_version.s{s}").set(self._shard_version[s])

    def apply(self, grads: Dict[str, torch.Tensor]) -> int:
        """Apply one worker's gradients across the S shards; returns the
        aggregate version once all landed. A whole-tree writer (reset,
        adopt) runs before this update's first shard or after its last."""
        with self._write_mutex:
            with self._lock:
                self._inflight += 1
        try:
            futures = [self._pool.submit(self._apply_one_shard, s, grads)
                       for s in range(self.shards)]
            for f in futures:
                f.result()
        finally:
            with self._lock:
                self._inflight -= 1
                self._lock.notify_all()
        with self._lock:
            self._updates += 1
            self._state.step += 1
            return self._version

    def _params_locked(self) -> Dict[str, torch.Tensor]:
        if self._params_version != self._version:
            self._params = dict(self._flat)
            self._params_version = self._version
        return self._params

    def read(self):
        with self._lock:
            return self._params_locked(), self._state.ef_state, self._version

    def read_if_newer(self, version: int):
        with self._lock:
            if self._version == version:
                return None, None, self._version
            return self._params_locked(), self._state.ef_state, self._version

    def read_min(self, min_version: int, have_version: int, timeout: Optional[float] = None):
        with self._lock:
            self._lock.wait_for(lambda: self._version >= min_version, timeout)
            if self._version == have_version:
                return None, None, self._version
            return self._params_locked(), self._state.ef_state, self._version

    @property
    def state(self) -> TrainState:
        """The whole-tree state: the master params and an optimizer over all
        of them whose per-parameter state is the shards' (cached a version)."""
        with self._lock:
            if self._assembled is not None and self._assembled_version == self._version:
                return self._assembled
            version = self._version
            base = self._state
            shard_opt = list(self._shard_opt)
        merged = self._optimizer(list(base.opt_params.values()))
        for s, names in enumerate(self._assign):
            source = shard_opt[s].state if shard_opt[s] is not None else base.optimizer.state
            for n in names:
                t = base.opt_params[n]
                if t in source:
                    merged.state[t] = source[t]
        assembled = TrainState(step=base.step, params=base.params, optimizer=merged,
                               ef_state=base.ef_state, opt_params=base.opt_params,
                               layout=base.layout)
        with self._lock:
            if self._version == version:
                self._assembled, self._assembled_version = assembled, version
        return assembled

    @contextlib.contextmanager
    def _all_shard_mutexes(self):
        with contextlib.ExitStack() as stack:
            for m in self._shard_mutex:
                stack.enter_context(m)
            yield

    def _quiesce(self):
        """Wait (bounded) for in-flight applies; callers hold _write_mutex."""
        with self._lock:
            if not self._lock.wait_for(lambda: self._inflight == 0, timeout=600.0):
                raise RuntimeError("sharded PS apply did not quiesce within 600s; cannot "
                                   "safely reset/adopt a whole-tree state")

    def _resplit(self, state: TrainState):
        """Adopt a whole-tree state (callers hold every mutex): the shards'
        optimizers are made again from its optimizer's state."""
        params = _publish(state.params)
        with self._lock:
            self._state = state
            self._shard_opt = [None] * self.shards
            self._flat = dict(params)
            self._version += 1
            self._updates = 0
            self._assembled = None
            self._lock.notify_all()

    def reset(self, state: TrainState):
        with self._write_mutex:
            self._quiesce()
            with self._all_shard_mutexes():
                self._resplit(state)

    def adopt(self, state: TrainState, place_fn) -> None:
        with self._write_mutex:
            self._quiesce()
            if state is self._state or state is self._assembled:
                return
            if self._updates != 0:
                raise RuntimeError(
                    "AsyncPSRunner.run was handed a state that is not the service's current "
                    "state after updates were already applied; use restore(state) to adopt a "
                    "checkpoint explicitly")
            placed = place_fn(state)
            with self._all_shard_mutexes():
                self._resplit(placed)

    def close(self):
        self._pool.shutdown(wait=False)


class AsyncWorker:
    """One logical worker's handle in this process."""

    def __init__(self, runner: "AsyncPSRunner", worker_id: int):
        self._runner = runner
        self.worker_id = worker_id
        self.steps_completed = 0
        self.last_version_read = -1

    def step(self, batch, timeout: Optional[float] = None):
        """One gated step: wait for the bound, read the current version,
        compute gradients on it, push them. Returns the loss (``(loss,
        aux)`` with ``has_aux``)."""
        r = self._runner
        if _faults.armed():
            _faults.maybe_hang(step=self.steps_completed, worker=self.worker_id)
            if _faults.should_fire("worker_crash", step=self.steps_completed,
                                   worker=self.worker_id):
                r.controller.retire(self.worker_id)
                raise _faults.WorkerCrashed(f"worker {self.worker_id} crashed by fault "
                                            f"injection at step {self.steps_completed}")
        r.controller.start_step(self.worker_id, timeout)
        params, ef_state, version = r.service.read()
        self.last_version_read = version
        with _device_scope(r.device):
            sharded = r.shard_batch(batch)
            r._maybe_dump_async_graphs(params, sharded, ef_state)
            # Gradient programs run one at a time, complete before the apply.
            # graftlint: disable=GL001(this lock EXISTS to serialize execution — holding it across the gradient program and its sync is the point, so two workers' steps never interleave their collectives)
            with r._collective_lock:
                grads, loss, aux = r.grad_fn(params, sharded, ef_state)
                _sync(r.device)
            r.service.apply(grads)
        r.controller.finish_step(self.worker_id)
        self.steps_completed += 1
        if r.has_aux:
            return loss, aux
        return loss


class AsyncPSRunner(DistributedRunner):
    """Async / bounded-staleness runner, selected when the compiled strategy
    asks for a non-synchronous PS regime (``sync=False`` or ``staleness > 0``
    on a PS node). ``run`` is the drop-in step of one worker; several
    in-process workers step through :meth:`worker` handles; a worker process
    of a multi-node run steps over the TCP transport
    (:mod:`autodist_tpu_torch.parallel.ps_transport`).

    Each process runs its own one-device program (the plan's mesh axes all
    1, whatever the strategy's): processes meet only at the parameter
    service. ``zero`` (default ``AUTODIST_ZERO``) shards the chief's apply:
    N > 1 shards, 1 the default count, 0 off."""

    # Default gate timeout of run(): a worker pool that never steps fails
    # instead of hanging.
    DEFAULT_STEP_TIMEOUT = 600.0

    # Every step round-trips through the service: no K-step program to fuse.
    supports_run_many = False
    independent = True

    def __init__(self, compiled_strategy, model_spec, loss_fn: Callable, optimizer: Callable,
                 device: torch.device, plan: Optional[ShardingPlan] = None,
                 has_aux: bool = False, num_workers: int = 1,
                 ps_address: Optional[str] = None, zero: Optional[int] = None,
                 batch_size: Optional[int] = None):
        plan = plan if plan is not None \
            else ShardingPlan.from_strategy(compiled_strategy, model_spec)
        if plan.has_compression:
            raise NotImplementedError("Gradient compression is not supported in the async PS mode")
        if plan.num_devices > 1:
            _log.info("AsyncPSRunner: each process runs the strategy's mesh %s on its own "
                      "device", dict(plan.mesh_axes))
        zero = const.env_int(const.AUTODIST_ZERO, 0) if zero is None else int(zero)
        super().__init__(compiled_strategy, model_spec, loss_fn, optimizer, device,
                         plan=plan.local(compiled_strategy, model_spec), batch_size=batch_size,
                         mesh=single_device_mesh(), has_aux=has_aux, zero=zero)
        self.ps_shards = zero if zero > 1 else (DEFAULT_PS_SHARDS if zero else 1)
        self.num_workers = max(1, num_workers)
        self.staleness = self.plan.max_staleness
        self.controller = StalenessController(self.num_workers, self.staleness)
        self.service: Optional[ParameterService] = None
        self._ps_address = ps_address
        self._ps_listen_sock = None   # pre-bound by AutoDist._setup
        self._ps_server = None
        self._remote_worker = None
        self._last_returned = None
        self._workers = {i: AsyncWorker(self, i) for i in range(self.num_workers)}
        self._membership_lock = threading.Lock()
        # Gradient and apply programs run one at a time in this process.
        self._collective_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        _log.info("AsyncPSRunner: %d worker(s), staleness=%s%s", self.num_workers,
                  self.staleness or "unbounded",
                  f", transport={ps_address}" if ps_address else "")

    @property
    def _is_remote_worker(self) -> bool:
        return bool(self._ps_address) and const.is_worker()

    @property
    def grad_fn(self):
        return self._grad_fn

    @property
    def has_aux(self) -> bool:
        return self._has_aux

    # ------------------------------------------------------------------- state
    def init(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """The state, and (on the chief) the parameter service over it, and
        the transport's server when the run has a PS address. On a worker
        process the state is a template: the chief's is authoritative."""
        state = super().init(params)
        if self._is_remote_worker:
            return state
        if self.ps_shards > 1:
            self.service = ShardedParameterService(
                state, self._optimizer, self.ps_shards, self._locked_exec,
                capturable=self.device.type == "cuda")
        else:
            self.service = ParameterService(state, self._locked_apply)
        if self._ps_address:
            from autodist_tpu_torch.parallel.ps_transport import PSServer
            host, _, port = self._ps_address.rpartition(":")
            self._ps_server = PSServer(self, host=host, port=int(port),
                                       listen_sock=self._ps_listen_sock)
        return state

    def evaluate(self, state: TrainState, batch, fn=None):
        """Forward-only evaluation of the service's current parameters. A
        worker process holds only a template, so it raises."""
        if self._is_remote_worker:
            raise RuntimeError(
                "evaluate() is not available on async worker processes: the local state is a "
                "template; the chief's parameter service owns the authoritative parameters. "
                "Evaluate on the chief process")
        if self.service is not None:
            state = self.service.state
        return super().evaluate(state, batch, fn)

    def _locked_apply(self, state: TrainState, grads: Dict[str, torch.Tensor]) -> TrainState:
        """The service's apply: one optimizer step on the gradients (moved to
        the device), complete before the lock is released."""
        return self._locked_exec(lambda: self._apply_on_device(state, grads))

    def _apply_on_device(self, state: TrainState, grads) -> TrainState:
        self._apply_update(state, {k: g.to(self.device) for k, g in grads.items()})
        return state

    def _locked_exec(self, fn: Callable):
        """``fn()`` under this runner's card and execution lock, its device
        work complete on return."""
        # graftlint: disable=GL001(execution-serialization lock by design — the PS apply, whole or per apply shard, must not interleave its collectives with a worker grad program)
        with _device_scope(self.device), self._collective_lock:
            out = fn()
            _sync(self.device)
            return out

    def wire_stats(self):
        """The transport's wire counters (the worker's client side, or the
        chief's server aggregate); None off the transport."""
        if self._remote_worker is not None:
            return self._remote_worker.wire_counters
        if self._ps_server is not None:
            return self._ps_server.wire
        return None

    def close(self):
        """Release the transport endpoints; safe to call repeatedly."""
        if self._ps_server is not None:
            self._ps_server.close()
            self._ps_server = None
        if self._remote_worker is not None:
            self._remote_worker.close()
            self._remote_worker = None
        if self.service is not None:
            self.service.close()

    # ------------------------------------------------------------------ workers
    def worker(self, worker_id: int) -> AsyncWorker:
        if self.service is None:
            raise RuntimeError("Call init(params) before creating workers")
        if worker_id not in self._workers:
            raise ValueError(f"worker_id {worker_id} has no handle (known: "
                             f"{sorted(self._workers)}); use add_worker({worker_id}) to "
                             f"admit it")
        return self._workers[worker_id]

    def add_worker(self, worker_id: Optional[int] = None, with_generation: bool = False):
        """(Re-)admit a worker slot mid-run: a replacement for a retired one,
        or a new slot (``None``); returns its handle (and, with
        ``with_generation``, the generation read with the registration).
        Thread-safe: the transport calls it from its handler threads."""
        if self.service is None:
            raise RuntimeError("Call init(params) before creating workers")
        was_retired = self.controller.slot_state(worker_id) == "retired"
        wid, gen = self.controller.register_with_generation(worker_id)
        with self._membership_lock:
            self.num_workers = max(self.num_workers, wid + 1)
            if wid not in self._workers:
                self._workers[wid] = AsyncWorker(self, wid)
        if was_retired:
            _recovery.log_rejoin(wid, gen, seeded_step=self.controller.steps[wid])
        _log.info("AsyncPSRunner: admitted worker %d (gate now %d slots)", wid,
                  len(self.controller.steps))
        if with_generation:
            return self._workers[wid], gen
        return self._workers[wid]

    def _place(self, state: TrainState) -> TrainState:
        """A foreign state's tensors on this runner's device."""
        if all(t.device == self.device for t in state.params.values()):
            return state
        return TrainState(step=state.step,
                          params={k: t.detach().to(self.device).requires_grad_(t.requires_grad)
                                  for k, t in state.params.items()},
                          optimizer=state.optimizer, ef_state=state.ef_state,
                          opt_params=state.opt_params, layout=state.layout)

    def _maybe_dump_async_graphs(self, params, sharded, ef_state):
        """``AUTODIST_DUMP_GRAPHS`` for the async regime
        (``staleness.py:1074-1092``), once, from whichever worker steps
        first: ``0-original`` the user's loss, ``1-distributed`` the gated
        gradient step the workers run, both traced on fake tensors."""
        if not const.ENV.AUTODIST_DUMP_GRAPHS.val:
            return
        with self._dump_lock:
            if self._dumped:
                return
            self._dumped = True
        from autodist_tpu_torch.utils import tracing
        tracing.dump_stage("async_step", "0-original", self._loss_fn, params, dict(sharded))
        tracing.dump_stage("async_step", "1-distributed",
                           lambda p, b: self.grad_fn.local(p, b)[:2], params, dict(sharded))

    def collect_cluster_trace(self, path: str, since_ns=None) -> str:
        """The cluster timeline (``staleness.py:974-996``): this process's
        span ring merged with every ring the remote workers pushed
        (``AUTODIST_TRACE_PULL=1``), one clock-rebased ``pid`` lane a worker,
        as Chrome trace JSON at ``path``. On a worker process: its own ring,
        rebased by its estimated chief-clock offset, and the chief's, pulled
        over the ``trace`` opcode."""
        rw = self._remote_worker
        if rw is not None:
            if rw.clock_offset_ns is None:
                rw.estimate_clock_offset()
            local = telemetry.local_trace_state(since_ns, worker_id=rw.worker_id,
                                                clock_offset_ns=rw.clock_offset_ns)
            return telemetry.merge_trace_states([local, rw.trace(since_ns)], path)
        return telemetry.collect_cluster_trace(path, server=self._ps_server,
                                               since_ns=since_ns)

    def restore(self, state: TrainState):
        """Adopt a (checkpoint-restored) state as the service's."""
        if self.service is None:
            raise RuntimeError("Call init(params) before restore()")
        self.service.reset(self._place(state))

    # --------------------------------------------------------------------- run
    def run(self, state, batch=None, worker_id: int = 0, fetches=None):
        """Drop-in step: one async step on ``worker_id``; returns
        ``(current_state, fetched)``. The service owns the state: the passed
        one is normally the previous return and is ignored; a foreign state
        before the first update is a checkpoint restore and re-seeds the
        service; a foreign state later raises. No ``fetches`` (the regime has
        no in-step fetch point)."""
        if fetches is not None:
            raise TypeError("AsyncPSRunner.run() takes no fetches: the async regime has no "
                            "in-step fetch point")
        if batch is None:
            state, batch = None, state
        if self._is_remote_worker:
            if self._remote_worker is None:
                from autodist_tpu_torch.parallel.ps_transport import RemotePSWorker
                self._remote_worker = RemotePSWorker(
                    self._ps_address, self,
                    worker_id=const.ENV.AUTODIST_PROCESS_ID.val)
            return state, self._remote_worker.step(batch, timeout=self.DEFAULT_STEP_TIMEOUT)
        if state is not None and self.service is not None and state is not self._last_returned:
            self.service.adopt(state, self._place)
        fetched = self.worker(worker_id).step(batch, timeout=self.DEFAULT_STEP_TIMEOUT)
        current = self.service.state
        self._last_returned = current
        return current, fetched

    __call__ = run

    def run_many(self, state, batches, fetches=None):
        raise RuntimeError(f"{type(self).__name__} does not support run_many: the async "
                           f"regime's parameter service applies gradients step by step; use "
                           f"run() (or train(..., unroll=1))")

    def plan_costs(self, params, example_batch, unroll: int = 1):
        if unroll > 1:
            raise RuntimeError(f"{type(self).__name__} has no fused multi-step program to "
                               f"probe at unroll={unroll}; probe unroll=1")
        return super().plan_costs(params, example_batch, unroll)
