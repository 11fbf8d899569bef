"""autodist_tpu_torch: the PyTorch and CUDA port of ``autodist_tpu``.

Module paths mirror the JAX package, so each counterpart is found by name.
The port imports ``torch`` and never ``jax``, ``flax``, ``optax`` or anything
of ``autodist_tpu``; it keeps its own copies of what it needs. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far: the flagship training step, ``AutoDist(...).function(loss_fn,
params, optimizer, accumulation_steps=k)`` under the ``AllReduce`` strategy on
one card, with the fused LM-head loss in hand-written Hopper kernels
(:mod:`autodist_tpu_torch.ops.fused_xent`); and its long-context form
(``python -m autodist_tpu_torch.examples.long_context_lm``): flash attention
in hand-written Hopper kernels (:mod:`autodist_tpu_torch.ops.flash_attention`)
with rematerialized blocks. ``ROADMAP.md`` lists what is next.
"""

from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.models.transformer_lm import (TransformerLM,
                                                      TransformerLMConfig)
from autodist_tpu_torch.params import from_jax_params, to_jax_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce, StrategyBuilder

__all__ = ["AutoDist", "AllReduce", "ResourceSpec", "StrategyBuilder",
           "TransformerLM", "TransformerLMConfig", "from_jax_params",
           "to_jax_params"]
