"""User API: the AutoDist class (``autodist_tpu/autodist.py``).

``AutoDist(resource spec, builder)`` -> ``create_distributed_session`` or
``function``, under every builder of :mod:`autodist_tpu_torch.strategy`
(default ``PSLoadBalancing()``, as in the JAX package):

- synchronous plans run the :class:`DistributedRunner` over a mesh of one or
  more ranks, one process per device, launched by torchrun or, from a
  multi-node resource spec, by the :class:`~autodist_tpu_torch.coordinator.Coordinator`
  (the ranks join one ``torch.distributed`` group), with ``zero=`` /
  ``AUTODIST_ZERO`` weight-update sharding;
- async plans (``PS(sync=False)``, ``staleness > 0``) run the
  :class:`~autodist_tpu_torch.parallel.staleness.AsyncPSRunner`: in-process
  workers, or on a multi-node spec one worker a process, meeting at the
  chief's parameter service over the TCP transport;
- the sequence-parallel session built on it
  (:func:`autodist_tpu_torch.parallel.sequence.create_sequence_parallel_session`)
  and the plan search (``strategy_builder="autotune"``, ``tune=True`` or
  ``AUTODIST_TUNE``: :mod:`autodist_tpu_torch.strategy.autotune`).

On a multi-node spec the chief builds the strategy, serializes it and
re-executes the user's command on every other node with the worker role
env; a worker process loads the strategy by its id
(``AUTODIST_STRATEGY_ID``).
"""

import atexit
import logging
import socket
from typing import Callable, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel import multihost
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import DistributedRunner, step_function
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.utils.device import resolve_device

_log = logging.getLogger("autodist_tpu_torch")


class AutoDist:
    """Entry point: resource spec + strategy builder -> distributed execution."""

    def __init__(self, resource_spec_file: Union[str, ResourceSpec, None] = None,
                 strategy_builder: Union[StrategyBuilder, str, None] = None, *,
                 resource_info: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None):
        """``resource_spec_file``: a YAML path, inline YAML text or a parsed
        :class:`ResourceSpec`; or ``resource_info=`` as a dict; neither gives
        the local default (one device per rank of torchrun's world, else the
        visible cards). ``strategy_builder`` defaults to
        ``PSLoadBalancing()``, as in the JAX package; the string
        ``"autotune"`` makes the first ``create_distributed_session`` run
        the plan autotuner and apply its winning builder and knobs (a warm
        plan cache skips the search). ``device`` defaults to
        ``cuda:$LOCAL_RANK`` (``cuda:0`` outside torchrun) and raises
        ``RuntimeError`` when CUDA is absent; pass ``"cpu"`` to run on the
        host."""
        self._autotune = False
        if isinstance(strategy_builder, str):
            if strategy_builder != "autotune":
                raise ValueError(f"unknown strategy name {strategy_builder!r}; the only "
                                 f"string strategy is 'autotune' (pass a StrategyBuilder "
                                 f"instance otherwise)")
            self._autotune = True
            strategy_builder = None
        self._tuned_plan = None
        self.device = resolve_device(device)
        if isinstance(resource_spec_file, ResourceSpec):
            self._resource_spec = resource_spec_file
        else:
            self._resource_spec = ResourceSpec(resource_spec_file,
                                               resource_info=resource_info)
        self._strategy_builder = strategy_builder or PSLoadBalancing()
        self._strategy: Optional[Strategy] = None
        self._compiled: Optional[Strategy] = None
        self._model_signature = None
        self._cluster = None
        self._coordinator = None
        self._ps_listen_sock = None
        self._ps_address: Optional[str] = None
        self._session = None

    @property
    def resource_spec(self) -> ResourceSpec:
        return self._resource_spec

    @property
    def is_chief(self) -> bool:
        """Not a coordinator-launched worker (``AUTODIST_WORKER`` unset)."""
        return not const.is_worker()

    def build_strategy(self, model_spec: ModelSpec) -> Strategy:
        """Build the strategy (the chief) or load the chief's by the id the
        coordinator shipped (a worker process)."""
        if self._strategy is not None:
            return self._strategy
        if self.is_chief:
            self._strategy = self._strategy_builder.build(model_spec, self._resource_spec)
        else:
            strategy_id = const.env_str(const.AUTODIST_STRATEGY_ID)
            if not strategy_id:
                raise RuntimeError("Worker process has no AUTODIST_STRATEGY_ID; the "
                                   "coordinator must ship the chief's strategy id")
            self._strategy = Strategy.deserialize(strategy_id)
            _log.info("Loaded strategy %s (worker)", strategy_id)
        return self._strategy

    # ------------------------------------------------------------------ cluster
    def _setup(self, strategy: Strategy, async_mode: bool) -> None:
        """Multi-node setup at the first session (``autodist.py:134-167``):
        the cluster spec; on the chief, the PS port reserved before its
        address ships (async plans) and the worker processes launched;
        synchronous plans then join one process group. A teardown is
        registered at exit."""
        if self._cluster is not None or self._resource_spec.num_nodes <= 1:
            return
        from autodist_tpu_torch.cluster import Cluster
        from autodist_tpu_torch.coordinator import Coordinator
        self._cluster = Cluster(self._resource_spec)
        self._cluster.start()
        if self.is_chief:
            self._coordinator = Coordinator(strategy, self._cluster)
            extra_env = None
            if async_mode:
                host = self._resource_spec.chief_address
                sock = socket.socket()
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sock.bind((host, 0))
                self._ps_listen_sock = sock
                self._ps_address = f"{host}:{sock.getsockname()[1]}"
                extra_env = {const.AUTODIST_PS_ADDR: self._ps_address}
            self._coordinator.launch_clients(extra_env=extra_env)
        if not async_mode:
            multihost.maybe_initialize_multihost(self.device, cluster=self._cluster)
        atexit.register(self._teardown)

    def _teardown(self) -> None:
        """Join the workers (bounded), close the session's transport, then
        terminate what the cluster launched (``autodist.py:169-182``)."""
        try:
            if self._coordinator is not None:
                self._coordinator.join(timeout=10.0)
        finally:
            if self._session is not None and hasattr(self._session, "close"):
                self._session.close()
            # The exit hook holds this instance: let the session's state go.
            self._session = None
            if self._cluster is not None:
                self._cluster.terminate()

    def _compile(self, model_spec: ModelSpec) -> Strategy:
        # One model per AutoDist instance: a strategy built for another model
        # would silently mis-distribute this one.
        signature = tuple(sorted((n, p.shape) for n, p in model_spec.trainable.items()))
        if self._compiled is not None and signature != self._model_signature:
            raise RuntimeError(
                "This AutoDist instance already compiled a strategy for a different "
                "model; create a new AutoDist per model")
        if self._compiled is None:
            strategy = self.build_strategy(model_spec)
            self._compiled = StrategyCompiler(model_spec, self._resource_spec).compile(strategy)
            self._model_signature = signature
        return self._compiled

    def create_distributed_session(self, loss_fn: Callable,
                                   params: Mapping[str, torch.Tensor], optimizer: Callable,
                                   example_batch=None,
                                   sparse_names: Optional[Sequence[str]] = None,
                                   has_aux: bool = False,
                                   accumulation_steps: int = 1,
                                   batch_size: Optional[int] = None,
                                   zero: Optional[int] = None,
                                   tune: Optional[bool] = None,
                                   num_workers: Optional[int] = None,
                                   health: Optional[bool] = None) -> DistributedRunner:
        """Compile the strategy for this model and return the runner.

        ``params`` is a flat ``{state-dict key: tensor}`` dict; ``optimizer``
        a factory ``optimizer(list_of_params) -> torch.optim.Optimizer``.
        Sparse flags follow the JAX package's rule (``_model_spec_for``):
        ``sparse_names`` if given; else the walk of ``loss_fn`` traced on
        ``example_batch`` (:meth:`ModelSpec.from_loss_fn`, which also finds
        each sparse parameter's index leaf, the sparse wire's indices);
        else no parameter is sparse. ``zero`` (default ``AUTODIST_ZERO``)
        turns on ZeRO-style weight-update sharding over the data axes (under
        an async plan, ``zero=N > 1`` shards the chief's apply N ways). A
        synchronous mesh of more than one rank joins the process group from
        torchrun's environment or the coordinator's first; every rank calls
        this with the same arguments. ``health`` (default
        ``AUTODIST_HEALTH``) makes a synchronous runner compute the
        training-health bundle every step (``runner.last_health``).

        A plan of PS nodes that are not synchronous (``sync=False`` or
        ``staleness > 0``) returns an
        :class:`~autodist_tpu_torch.parallel.staleness.AsyncPSRunner`;
        ``num_workers`` sizes its worker pool (default: one slot a process of
        a multi-node cluster, else one). Such a plan takes no
        ``accumulation_steps > 1``.

        ``tune`` (default: ``AutoDist(strategy_builder="autotune")`` or the
        ``AUTODIST_TUNE`` flag) runs the plan autotuner before the first
        session (:func:`autodist_tpu_torch.strategy.autotune.autotune`):
        its winning builder, ``zero`` and ``accumulation_steps`` are applied
        (explicit arguments win) and its plan is ``runner.tuned_plan``,
        whose ``unroll`` ``train()`` adopts when given none. The winner is
        stored in the ``AUTODIST_PLAN_CACHE`` file, so a relaunch of the
        same job applies it with no search. A failed search keeps the
        default builder, with a warning. A builder that models memory
        (``AutoStrategy``) is handed ``optimizer``."""
        self._maybe_autotune(tune, loss_fn, params, optimizer, example_batch,
                             sparse_names, has_aux)
        if self._tuned_plan is not None:
            if accumulation_steps == 1:
                accumulation_steps = self._tuned_plan.accumulation_steps
            if zero is None and self._tuned_plan.zero:
                zero = self._tuned_plan.zero
        model_spec, compiled, plan = self._plan(loss_fn, params, optimizer, example_batch,
                                                sparse_names)
        if plan.is_async and accumulation_steps > 1:
            # Before _setup: failing after the launch would leave workers behind.
            raise ValueError("accumulation_steps > 1 is a synchronous-runner feature; the "
                             "async/bounded-stale regime steps micro-batches as ordinary steps")
        self._setup(compiled, async_mode=plan.is_async)
        if plan.is_async:
            from autodist_tpu_torch.parallel.staleness import AsyncPSRunner
            if num_workers:
                workers = num_workers
            elif self._cluster is not None:
                workers = self._cluster.num_processes
            else:
                workers = 1
            runner = AsyncPSRunner(compiled, model_spec, loss_fn, optimizer, self.device,
                                   plan=plan, has_aux=has_aux, num_workers=workers,
                                   ps_address=self._ps_address
                                   or const.env_str(const.AUTODIST_PS_ADDR) or None,
                                   zero=zero, batch_size=batch_size)
            runner._ps_listen_sock = self._ps_listen_sock
            runner.tuned_plan = self._tuned_plan
            self._session = runner
            return runner
        if plan.num_devices > 1 and self._cluster is None:
            multihost.maybe_initialize_multihost(self.device)
        runner = DistributedRunner(compiled, model_spec, loss_fn, optimizer, self.device,
                                   plan=plan, accumulation_steps=accumulation_steps,
                                   batch_size=batch_size, has_aux=has_aux, zero=zero,
                                   health=health)
        runner.tuned_plan = self._tuned_plan
        return runner

    def _plan(self, loss_fn, params, optimizer, example_batch, sparse_names):
        """``(model_spec, compiled strategy, plan)`` for this model, the
        builder having observed ``optimizer`` if it models memory."""
        model_spec = self._model_spec_for(loss_fn, params, example_batch, sparse_names)
        observe = getattr(self._strategy_builder, "observe_optimizer", None)
        if observe is not None and self._compiled is None:
            observe(optimizer)
        compiled = self._compile(model_spec)
        return model_spec, compiled, ShardingPlan.from_strategy(compiled, model_spec)

    def _maybe_autotune(self, tune: Optional[bool], loss_fn, params, optimizer,
                        example_batch, sparse_names, has_aux) -> None:
        """Run the plan autotuner once per instance, before the first
        strategy build, and install its winner (``autodist.py:289-352``).
        Skipped, with a warning, once a strategy is built, in a program of
        several processes (the tuned knobs would not reach the other
        ranks), without an example batch, or on a multi-node spec; a failed
        search keeps the default builder with a warning."""
        if tune is None:
            tune = self._autotune or const.env_armed(const.AUTODIST_TUNE)
        if not tune or self._tuned_plan is not None:
            return
        if self._strategy is not None or self._compiled is not None:
            _log.warning("AutoDist: tune requested after a strategy was already built; "
                         "keeping the existing strategy")
            return
        if dist.is_initialized() and dist.get_world_size() > 1:
            _log.warning("AutoDist: tune=True in a program of several processes: the tuned "
                         "execution knobs (zero/unroll/accumulation) cannot ship to the "
                         "other ranks, so the search is skipped; tune one process and pass "
                         "the winning knobs explicitly")
            return
        if example_batch is None:
            _log.warning("AutoDist: tune=True needs an example_batch to probe candidate "
                         "plans; skipping the search")
            return
        if self._resource_spec.num_nodes > 1:
            _log.warning("AutoDist: tune=True on a multi-node spec: the autotuner measures "
                         "on local devices only; skipping the search")
            return
        from autodist_tpu_torch.strategy.autotune import autotune
        try:
            plan = autotune(loss_fn, params, optimizer, example_batch,
                            resource_spec=self._resource_spec, sparse_names=sparse_names,
                            has_aux=has_aux, device=self.device)
        except Exception as e:  # noqa: BLE001 — a failed search keeps the default
            _log.warning("AutoDist: plan autotune failed (%s: %s); keeping the default "
                         "strategy builder", type(e).__name__, e)
            return
        self._tuned_plan = plan
        self._strategy_builder = plan.make_builder()
        # Profiles and flight-recorder manifests name the plan a run executed.
        from autodist_tpu_torch.telemetry import profiling as _profiling
        _profiling.set_applied_plan(dict(plan.to_dict(), name=plan.name))
        _log.info("AutoDist: applying tuned plan %s (%s)", plan.name,
                  "cache hit" if plan.from_cache else f"searched in {plan.search_s:.2f}s")

    @staticmethod
    def _model_spec_for(loss_fn, params, example_batch, sparse_names) -> ModelSpec:
        if sparse_names is not None:
            return ModelSpec(params, sparse_names=sparse_names)
        if example_batch is not None:
            return ModelSpec.from_loss_fn(loss_fn, params, example_batch)
        return ModelSpec(params)

    def function(self, loss_fn: Callable, params: Mapping[str, torch.Tensor],
                 optimizer: Callable, example_batch=None,
                 sparse_names: Optional[Sequence[str]] = None,
                 has_aux: bool = False, accumulation_steps: int = 1,
                 batch_size: Optional[int] = None, zero: Optional[int] = None,
                 tune: Optional[bool] = None, num_workers: Optional[int] = None,
                 health: Optional[bool] = None) -> Callable:
        """``step(batch, fetches=None) -> loss`` (what
        :meth:`DistributedRunner.run` fetches) carrying the training state
        inside; the first call's runner is reused by every later one.
        ``step.runner``, ``step.get_state()`` and ``step.evaluate(batch,
        fn=None)`` expose it. Under an async plan ``step`` is one worker's
        loop (slot 0; ``num_workers`` sizes the pool, as in
        :meth:`create_distributed_session`) and has no ``evaluate`` (a worker
        process's state is a template)."""
        runner = self.create_distributed_session(
            loss_fn, params, optimizer, example_batch, sparse_names, has_aux,
            accumulation_steps=accumulation_steps, batch_size=batch_size, zero=zero,
            tune=tune, num_workers=num_workers, health=health)
        step = step_function(runner, params)
        if runner.plan.is_async:
            del step.evaluate
        return step
