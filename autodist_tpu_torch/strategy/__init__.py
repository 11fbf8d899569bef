"""Strategy builders of the port. Only ``AllReduce`` is ported so far."""

from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler

__all__ = ["AllReduce", "Strategy", "StrategyBuilder", "StrategyCompiler"]
