"""Strategy builders of the port: ``AllReduce`` and ``SequenceParallel`` so far."""

from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.sequence_parallel_strategy import SequenceParallel

__all__ = ["AllReduce", "SequenceParallel", "Strategy", "StrategyBuilder",
           "StrategyCompiler"]
