"""Constants and environment flags the port shares across modules (its own
copy of the names it needs from ``autodist_tpu/const.py``)."""

import os

# Mesh axis names (the strategy's MeshConfig records them).
MESH_AXIS_DATA = "data"          # data parallelism (batch dim)
MESH_AXIS_REDUCE = "reduce"      # weight-update/PS sharding axis (ZeRO-style)
MESH_AXIS_MODEL = "model"        # tensor/variable partitioning axis
MESH_AXIS_SEQ = "seq"            # sequence/context parallelism axis
MESH_AXIS_EXPERT = "expert"      # expert parallelism axis
MESH_AXIS_PIPE = "pipe"          # pipeline parallelism axis

# ZeRO-style weight-update sharding (arXiv 2004.13336) for the synchronous
# runner: 0 off (the default), any other integer on. The JAX package's N > 1
# also shards the async PS apply, which the port has not ported.
AUTODIST_ZERO = "AUTODIST_ZERO"

# train()'s input pipeline: the prefetch queue's depth (0 = the synchronous
# feed) and the producer's worker threads (source pulls stay serialized).
PREFETCH_DEPTH = "AUTODIST_PREFETCH_DEPTH"
PREFETCH_WORKERS = "AUTODIST_PREFETCH_WORKERS"

# Directory for benchmark metric files (utils/benchmark_logger.py): set, the
# file sink; empty, the framework logger.
AUTODIST_BENCHMARK_LOG_DIR = "AUTODIST_BENCHMARK_LOG_DIR"

# Planes of the JAX package's train() that the port has not ported: each one
# armed in the environment makes train() raise instead of running without it.
UNPORTED_PLANES = {
    "AUTODIST_HEALTH": "the training-health monitors",
    "AUTODIST_PROFILE": "the performance-attribution plane",
    "AUTODIST_METRICS_PORT": "the OpenMetrics scrape endpoint",
    "AUTODIST_ALERT_ACTION": "the alert engine's actions",
}

_OFF = ("", "0", "false", "no", "off")


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def env_armed(name: str) -> bool:
    """Whether flag ``name`` is set to something other than off (the JAX
    package's boolean parse: empty, 0, false, no and off are off)."""
    return os.environ.get(name, "").strip().lower() not in _OFF


def is_worker() -> bool:
    """True when this process was launched by a coordinator as a worker
    replica (``AUTODIST_WORKER`` non-empty)."""
    return bool(os.environ.get("AUTODIST_WORKER", ""))


def is_chief_process() -> bool:
    """Not a coordinator-launched worker and, once a process group is up,
    rank 0 of it (``autodist_tpu/const.py:503-509``, plus the torch world's
    rank)."""
    import torch.distributed as dist
    if is_worker():
        return False
    return not dist.is_initialized() or dist.get_rank() == 0
