"""Host data pipeline (the port's counterpart of ``autodist_tpu/data``): the
native prefetch loader, the device feed, per-host sharded loading, and the
datasets (ImageNet records, masked-LM text, MovieLens ratings)."""

from autodist_tpu_torch.data import imagenet, mlm, movielens, prefetch, text_corpus
from autodist_tpu_torch.data.loader import (DataLoader, device_prefetch, save_shards,
                                            shard_files_for_process)
from autodist_tpu_torch.data.prefetch import (BoundedQueue, PrefetchProducer,
                                              assemble_global_batch, host_shard,
                                              host_shard_rows, prefetch_to_device)

__all__ = ["DataLoader", "device_prefetch", "save_shards",
           "shard_files_for_process", "imagenet", "mlm", "movielens",
           "text_corpus", "prefetch", "BoundedQueue", "PrefetchProducer",
           "prefetch_to_device", "host_shard", "host_shard_rows",
           "assemble_global_batch"]
