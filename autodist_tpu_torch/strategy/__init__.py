"""Strategy builders of the port (``autodist_tpu/strategy/__init__.py:22-38``):
the synchronous family of the JAX package's twelve, the single-axis builders
``ExpertParallel`` and ``Pipeline`` (for :mod:`~autodist_tpu_torch.models.moe`
and :mod:`~autodist_tpu_torch.models.pipeline_lm`), and the strategy search
(``AutoStrategy``, the tuner and ``autotune``)."""

from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.auto_strategy import AutoStrategy, choose_optimizer
from autodist_tpu_torch.strategy.autotune import (Candidate, TunedPlan, autotune,
                                                  enumerate_candidates, plan_cache_key)
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.expert_parallel_strategy import ExpertParallel
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.pipeline_strategy import Pipeline
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing, byte_size_load_fn
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy import \
    RandomAxisPartitionAR
from autodist_tpu_torch.strategy.sequence_parallel_strategy import SequenceParallel
from autodist_tpu_torch.strategy.tuner import (CandidateResult, TuneResult, measure_candidate,
                                               tune_strategy)
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import UnevenPartitionedPS

__all__ = ["AllReduce", "AutoStrategy", "Candidate", "CandidateResult", "ExpertParallel",
           "PS", "PSLoadBalancing", "Parallax", "PartitionedAR", "PartitionedPS", "Pipeline",
           "RandomAxisPartitionAR", "SequenceParallel", "Strategy", "StrategyBuilder",
           "StrategyCompiler", "TuneResult", "TunedPlan", "UnevenPartitionedPS", "autotune",
           "byte_size_load_fn", "choose_optimizer", "enumerate_candidates",
           "measure_candidate", "plan_cache_key", "tune_strategy"]
