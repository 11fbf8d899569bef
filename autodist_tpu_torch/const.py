"""Constants and environment flags the port shares across modules (its own
copy of the names it needs from ``autodist_tpu/const.py``)."""

import os
import tempfile

# Mesh axis names (the strategy's MeshConfig records them).
MESH_AXIS_DATA = "data"          # data parallelism (batch dim)
MESH_AXIS_REDUCE = "reduce"      # weight-update/PS sharding axis (ZeRO-style)
MESH_AXIS_MODEL = "model"        # tensor/variable partitioning axis
MESH_AXIS_SEQ = "seq"            # sequence/context parallelism axis
MESH_AXIS_EXPERT = "expert"      # expert parallelism axis
MESH_AXIS_PIPE = "pipe"          # pipeline parallelism axis

# ZeRO-style weight-update sharding (arXiv 2004.13336): 0 off (the default),
# any other integer on; under an async PS plan, N > 1 shards the chief's
# apply over N concurrent shards (1 picks parallel/staleness.py's default).
AUTODIST_ZERO = "AUTODIST_ZERO"

# train()'s input pipeline: the prefetch queue's depth (0 = the synchronous
# feed) and the producer's worker threads (source pulls stay serialized).
PREFETCH_DEPTH = "AUTODIST_PREFETCH_DEPTH"
PREFETCH_WORKERS = "AUTODIST_PREFETCH_WORKERS"

# The strategy search (strategy/autotune.py), with the JAX package's
# defaults (autodist_tpu/const.py:332-343): AUTODIST_TUNE runs the plan
# autotuner in create_distributed_session; AUTODIST_PLAN_CACHE is the plan
# cache file ("" = none); at most AUTODIST_TUNE_TOPK candidates are measured
# of at most AUTODIST_TUNE_BUDGET ranked. AUTODIST_MEM_BUDGET overrides the
# per-device memory budget in bytes when no card says (0 = unset).
# AUTODIST_PROFILE_DIR is where train() writes its profile under
# AUTODIST_PROFILE, and where the autotuner reads profiles to calibrate from.
AUTODIST_TUNE = "AUTODIST_TUNE"
AUTODIST_PLAN_CACHE = "AUTODIST_PLAN_CACHE"
AUTODIST_TUNE_TOPK = "AUTODIST_TUNE_TOPK"
AUTODIST_TUNE_BUDGET = "AUTODIST_TUNE_BUDGET"
AUTODIST_MEM_BUDGET = "AUTODIST_MEM_BUDGET"
AUTODIST_PROFILE_DIR = "AUTODIST_PROFILE_DIR"
TUNE_TOPK_DEFAULT = 3
TUNE_BUDGET_DEFAULT = 32

# Directory for benchmark metric files (utils/benchmark_logger.py): set, the
# file sink; empty, the framework logger.
AUTODIST_BENCHMARK_LOG_DIR = "AUTODIST_BENCHMARK_LOG_DIR"


# The working directory: serialized strategies (the chief-to-worker
# handshake by id) and the cluster spec file.
DEFAULT_WORKING_DIR = os.environ.get(
    "AUTODIST_WORKING_DIR", os.path.join(tempfile.gettempdir(), "autodist_tpu_torch"))
DEFAULT_SERIALIZATION_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_LOG_DIR = os.path.join(DEFAULT_WORKING_DIR, "logs")
DEFAULT_TRACE_DIR = os.path.join(DEFAULT_WORKING_DIR, "traces")
DEFAULT_GRAPH_DUMP_DIR = os.path.join(DEFAULT_WORKING_DIR, "graphs")
DEFAULT_COORDINATOR_PORT = 15000

# The cluster and the async PS plane (the JAX package's ENV flags of the same
# names and defaults, autodist_tpu/const.py:241-397): the role env the
# coordinator sets on a worker process, the PS transport's knobs, the
# recovery plane's policy and the fault-injection spec.
AUTODIST_WORKER = "AUTODIST_WORKER"
AUTODIST_STRATEGY_ID = "AUTODIST_STRATEGY_ID"
AUTODIST_MIN_LOG_LEVEL = "AUTODIST_MIN_LOG_LEVEL"
AUTODIST_IS_TESTING = "AUTODIST_IS_TESTING"
AUTODIST_DEBUG_REMOTE = "AUTODIST_DEBUG_REMOTE"
SYS_DATA_PATH = "SYS_DATA_PATH"
SYS_RESOURCE_PATH = "SYS_RESOURCE_PATH"
AUTODIST_COORDINATOR_ADDR = "AUTODIST_COORDINATOR_ADDR"
AUTODIST_COORDINATOR_PORT = "AUTODIST_COORDINATOR_PORT"
AUTODIST_NUM_PROCESSES = "AUTODIST_NUM_PROCESSES"
AUTODIST_PROCESS_ID = "AUTODIST_PROCESS_ID"
AUTODIST_PS_ADDR = "AUTODIST_PS_ADDR"
AUTODIST_PS_OVERLAP = "AUTODIST_PS_OVERLAP"
AUTODIST_NATIVE_TRANSPORT = "AUTODIST_NATIVE_TRANSPORT"
AUTODIST_WATCHDOG = "AUTODIST_WATCHDOG"
AUTODIST_WATCHDOG_SEC = "AUTODIST_WATCHDOG_SEC"
AUTODIST_EVICT_AFTER_S = "AUTODIST_EVICT_AFTER_S"
AUTODIST_WORKER_FAILURE = "AUTODIST_WORKER_FAILURE"
AUTODIST_RECOVER_MAX = "AUTODIST_RECOVER_MAX"
AUTODIST_WIRE_RETRIES = "AUTODIST_WIRE_RETRIES"
AUTODIST_WIRE_BACKOFF_S = "AUTODIST_WIRE_BACKOFF_S"
AUTODIST_FAULTS = "AUTODIST_FAULTS"
AUTODIST_WIRE_DTYPE = "AUTODIST_WIRE_DTYPE"
AUTODIST_COMPRESS_MIN_BYTES = "AUTODIST_COMPRESS_MIN_BYTES"
AUTODIST_SPARSE_PUSH = "AUTODIST_SPARSE_PUSH"

_OFF = ("", "0", "false", "no", "off")

def env_int(name: str, default: int) -> int:
    """An integer flag: ``default`` when unset or blank."""
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default).strip()


def env_float(name: str, default: float) -> float:
    """A float flag: ``default`` when unset or blank."""
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def env_flag(name: str, default: bool) -> bool:
    """A boolean flag: ``default`` when unset, else :func:`env_armed`'s parse."""
    if name not in os.environ:
        return default
    return env_armed(name)


def env_armed(name: str) -> bool:
    """Whether flag ``name`` is set to something other than off (the JAX
    package's boolean parse: empty, 0, false, no and off are off)."""
    return os.environ.get(name, "").strip().lower() not in _OFF


# The telemetry planes' flags and the others the copied modules read
# (autodist_tpu/const.py:241-404), with the JAX package's defaults.
# ``ENV.<NAME>.val`` reads one through the env_* parser of its default's
# type, so a flag parses the same whichever way a module reads it.
_ENV_DEFAULTS = {
    "AUTODIST_MIN_LOG_LEVEL": "INFO",
    "AUTODIST_PROCESS_ID": 0,
    "AUTODIST_WORKER": "",
    "AUTODIST_DUMP_GRAPHS": False,
    "AUTODIST_PEAK_FLOPS": "",
    "AUTODIST_PEAK_MEMBW": "",
    "AUTODIST_TELEMETRY": False,
    "AUTODIST_TELEMETRY_RING": 65536,
    "AUTODIST_TRACE_PULL": False,
    "AUTODIST_HEALTH": False,
    "AUTODIST_HEALTH_ACTION": "warn",
    "AUTODIST_HEALTH_ZMAX": 6.0,
    "AUTODIST_RECORDER": False,
    "AUTODIST_RECORDER_DIR": "",
    "AUTODIST_RECORDER_KEEP": 8,
    "AUTODIST_RECORDER_MIN_S": 30.0,
    "AUTODIST_PROFILE": False,
    "AUTODIST_PROFILE_DIR": "",
    "AUTODIST_METRICS_DIR": "",
    "AUTODIST_METRICS_PORT": "",
    "AUTODIST_METRICS_INTERVAL_S": 0.0,
    "AUTODIST_ALERT_RULES": "",
    "AUTODIST_ALERT_ACTION": "warn",
    "AUTODIST_RECOVER_MAX": 3,
    "AUTODIST_SANITIZE": "",
    "AUTODIST_REQTRACE": False,
    "AUTODIST_REQTRACE_RING": 4096,
    "AUTODIST_MEM_BUDGET": 0,
    "AUTODIST_MEM_PRESSURE": 0.92,
    # The serving plane (autodist_tpu/const.py:296-309): the transport
    # address clients and servers default to, the decode-slot capacity, the
    # batching discipline, the admission-queue bound, the server-side
    # completion wait; the router's replica count, the paged KV cache's page
    # length (0: the dense per-slot slab) and shared-prefix cache, and the
    # router's own address. ServeConfig.from_env() and Router read them.
    "AUTODIST_SERVE_ADDR": "",
    "AUTODIST_SERVE_MAX_BATCH": 8,
    "AUTODIST_SERVE_MODE": "continuous",
    "AUTODIST_SERVE_QUEUE": 256,
    "AUTODIST_SERVE_TIMEOUT_S": 120.0,
    "AUTODIST_SERVE_REPLICAS": 2,
    "AUTODIST_KV_PAGE_LEN": 0,
    "AUTODIST_PREFIX_CACHE": True,
    "AUTODIST_ROUTER_ADDR": "",
}


class _Flag:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    @property
    def val(self):
        """The flag's value: its table default when unset, else parsed by the
        env_* helper of the default's type."""
        default = _ENV_DEFAULTS[self.name]
        if isinstance(default, bool):
            return env_flag(self.name, default)
        if isinstance(default, int):
            return env_int(self.name, default)
        if isinstance(default, float):
            return env_float(self.name, default)
        return env_str(self.name, default)


class ENV:
    """``ENV.AUTODIST_HEALTH.val`` and the like, for every flag of
    :data:`_ENV_DEFAULTS`."""


for _name in _ENV_DEFAULTS:
    setattr(ENV, _name, _Flag(_name))
del _name


def is_worker() -> bool:
    """True when this process was launched by a coordinator as a worker
    replica (``AUTODIST_WORKER`` non-empty)."""
    return bool(ENV.AUTODIST_WORKER.val)


def is_chief_process() -> bool:
    """Not a coordinator-launched worker and, once a process group is up,
    rank 0 of it (``autodist_tpu/const.py:503-509``, plus the torch world's
    rank)."""
    import torch.distributed as dist
    if is_worker():
        return False
    return not dist.is_initialized() or dist.get_rank() == 0
