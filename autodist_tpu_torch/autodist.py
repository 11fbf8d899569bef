"""User API: the AutoDist class (``autodist_tpu/autodist.py:44,184-287,363-400``).

Ported so far: the synchronous single-node path, ``AutoDist(resource spec,
builder)`` -> ``create_distributed_session`` or ``function``, and the
sequence-parallel session built on it
(:func:`autodist_tpu_torch.parallel.sequence.create_sequence_parallel_session`).
Async PS, cluster launch and autotuning raise ``NotImplementedError``.
"""

from typing import Callable, Mapping, Optional, Sequence, Union

import torch

from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import DistributedRunner, step_function
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.utils.device import resolve_device


class AutoDist:
    """Entry point: resource spec + strategy builder -> distributed execution."""

    def __init__(self, resource_spec_file: Union[str, ResourceSpec, None] = None,
                 strategy_builder: Optional[StrategyBuilder] = None, *,
                 resource_info: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None):
        """``resource_spec_file``: a YAML path, inline YAML text or a parsed
        :class:`ResourceSpec`; or ``resource_info=`` as a dict; neither gives
        the local default. ``strategy_builder`` defaults to ``AllReduce()``
        (the JAX package defaults to ``PSLoadBalancing``, not ported yet).
        ``device`` defaults to ``cuda:$LOCAL_RANK`` (``cuda:0`` outside
        torchrun) and raises ``RuntimeError`` when CUDA is absent; pass
        ``"cpu"`` to run on the host."""
        if isinstance(strategy_builder, str):
            raise NotImplementedError("autotuning is not ported yet")
        self.device = resolve_device(device)
        if isinstance(resource_spec_file, ResourceSpec):
            self._resource_spec = resource_spec_file
        else:
            self._resource_spec = ResourceSpec(resource_spec_file,
                                               resource_info=resource_info)
        if self._resource_spec.num_nodes > 1:
            raise NotImplementedError("multi-node cluster launch is not ported yet")
        self._strategy_builder = strategy_builder or AllReduce()
        self._strategy: Optional[Strategy] = None
        self._compiled: Optional[Strategy] = None
        self._model_signature = None

    @property
    def resource_spec(self) -> ResourceSpec:
        return self._resource_spec

    def build_strategy(self, model_spec: ModelSpec) -> Strategy:
        if self._strategy is None:
            self._strategy = self._strategy_builder.build(model_spec, self._resource_spec)
        return self._strategy

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
                                   accumulation_steps: int = 1,
                                   batch_size: Optional[int] = None) -> DistributedRunner:
        """Compile the strategy for this model and return the runner.

        ``params`` is a flat ``{state-dict key: tensor}`` dict; ``optimizer``
        a factory ``optimizer(list_of_params) -> torch.optim.Optimizer``.
        Sparse flags come from ``sparse_names`` if given, else from the
        gather-only parameters ``loss_fn.sparse_names`` declares.
        ``example_batch`` is accepted for the JAX signature's sake: the port
        declares sparsity instead of tracing the loss."""
        del example_batch
        model_spec = (ModelSpec.from_loss_fn(loss_fn, params) if sparse_names is None
                      else ModelSpec(params, sparse_names=sparse_names))
        compiled = self._compile(model_spec)
        plan = ShardingPlan.from_strategy(compiled, model_spec)
        return DistributedRunner(compiled, model_spec, loss_fn, optimizer, self.device,
                                 plan=plan, accumulation_steps=accumulation_steps,
                                 batch_size=batch_size)

    def function(self, loss_fn: Callable, params: Mapping[str, torch.Tensor],
                 optimizer: Callable, example_batch=None,
                 sparse_names: Optional[Sequence[str]] = None,
                 accumulation_steps: int = 1,
                 batch_size: Optional[int] = None) -> Callable:
        """``step(batch) -> loss`` carrying the training state inside; the
        first call's runner is reused by every later one. ``step.runner``,
        ``step.get_state()`` and ``step.evaluate(batch, fn=None)`` expose it."""
        runner = self.create_distributed_session(
            loss_fn, params, optimizer, example_batch, sparse_names,
            accumulation_steps=accumulation_steps, batch_size=batch_size)
        return step_function(runner, params)
