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
with rematerialized blocks; and sequence parallelism over k cards
(``SequenceParallel`` with :mod:`autodist_tpu_torch.parallel.sequence`):
ring attention whose local step is the flash carry kernel; data
parallelism, ``train()`` and checkpoints; and the synchronous strategy
family (:mod:`autodist_tpu_torch.strategy`: PS and ``PSLoadBalancing``, the
default builder, with weight-update sharding, partitioned and padded
storage, ``Parallax``'s sparse wire, the gradient codecs, ZeRO and the
sharded checkpoint write); the sparse-parameter walk of the loss's graph
(:meth:`~autodist_tpu_torch.model_spec.ModelSpec.from_loss_fn`); Ulysses
sequence parallelism (:mod:`autodist_tpu_torch.parallel.ulysses`); the
native data loader (:mod:`autodist_tpu_torch.data.loader`); and the image
family: the CNN zoo (``models.resnet``, ``vgg``, ``densenet``,
``inception``), the ImageNet input plane (:mod:`autodist_tpu_torch.data.imagenet`),
the JAX package's self-contained examples and its ImageNet benchmark
(``examples.benchmark.imagenet``); and the text family: BERT and NCF
(``models.bert``, ``ncf``), their input (``data.text_corpus``, ``mlm``,
``movielens``), the benchmark logger (``utils.benchmark_logger``) and the
rest of the benchmark suite (``examples.benchmark``: ``bert``, ``ncf``,
``disk_input``, ``raw_torch_baseline``, ``run_all``). ``ROADMAP.md`` lists
what is next.
"""

from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.models.transformer_lm import (TransformerLM,
                                                      TransformerLMConfig)
from autodist_tpu_torch.params import from_jax_params, to_jax_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import (PS, AllReduce, Parallax, PartitionedAR,
                                         PartitionedPS, PSLoadBalancing,
                                         RandomAxisPartitionAR, SequenceParallel,
                                         StrategyBuilder, UnevenPartitionedPS)

__all__ = ["AutoDist", "AllReduce", "PS", "PSLoadBalancing", "Parallax", "PartitionedAR",
           "PartitionedPS", "RandomAxisPartitionAR", "ResourceSpec", "SequenceParallel",
           "StrategyBuilder", "TransformerLM", "TransformerLMConfig",
           "UnevenPartitionedPS", "from_jax_params", "to_jax_params"]
