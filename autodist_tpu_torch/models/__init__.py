"""Models of the port, with the JAX model zoo's parameter names and layouts.

The parallelism workloads are exported here, as ``autodist_tpu/models/__init__.py:20-28``
exports them; the other models are imported from their modules."""

from autodist_tpu_torch.models.moe import MoETransformerLM, MoETransformerLMConfig
from autodist_tpu_torch.models.pipeline_lm import PipelineLM, PipelineLMConfig

__all__ = ["MoETransformerLM", "MoETransformerLMConfig", "PipelineLM", "PipelineLMConfig"]
