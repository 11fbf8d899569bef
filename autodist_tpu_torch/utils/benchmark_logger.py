"""Structured benchmark logging (the port's copy of
``autodist_tpu/utils/benchmark_logger.py``).

- :class:`BaseBenchmarkLogger` prints structured metrics through the
  port's logger (``logging.getLogger("autodist_tpu_torch")``).
- :class:`BenchmarkFileLogger` appends one JSON object per line to
  ``metric.log`` / ``benchmark_run.log`` under a directory (the reference's
  file format: name/value/unit/global_step/timestamp/extras), byte for byte
  the JAX package's.
- :func:`gather_run_info` captures the run's environment: the torch and
  CUDA versions and the cards ``torch.cuda`` sees, where the JAX package
  records jax's platform and devices.
- :func:`mlperf_log` emits ``:::MLL``-style compliance lines.

``AUTODIST_BENCHMARK_LOG_DIR`` selects the file sink; unset, the base logger.
"""

import datetime
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from autodist_tpu_torch import const

_log = logging.getLogger("autodist_tpu_torch")

METRIC_LOG_FILE_NAME = "metric.log"
BENCHMARK_RUN_LOG_FILE_NAME = "benchmark_run.log"


class BaseBenchmarkLogger:
    """Log metrics through the port's logger (reference logger.py:108-140)."""

    def log_metric(self, name: str, value: float, unit: Optional[str] = None,
                   global_step: Optional[int] = None,
                   extras: Optional[Dict[str, Any]] = None):
        metric = _metric_dict(name, value, unit, global_step, extras)
        if metric is not None:
            _log.info("Benchmark metric: %s", metric)

    def log_run_info(self, run_info: Dict[str, Any]):
        _log.info("Benchmark run: %s", run_info)

    def log_metrics(self, snapshot: Dict[str, Any],
                    global_step: Optional[int] = None) -> int:
        """One metric row per entry of a ``{name: value}`` snapshot; returns
        the row count. A dict value (a histogram) logs its ``count`` as the
        value with the dict in ``extras``."""
        rows = 0
        for name, value in snapshot.items():
            if isinstance(value, dict):
                self.log_metric(name, value.get("count", 0), unit="count",
                                global_step=global_step, extras=value)
            else:
                self.log_metric(name, value, global_step=global_step)
            rows += 1
        return rows

    def on_finish(self, status: str = "success"):
        pass


class BenchmarkFileLogger(BaseBenchmarkLogger):
    """Append metrics as JSON lines under ``logging_dir``
    (reference logger.py:142-185)."""

    def __init__(self, logging_dir: str):
        self._logging_dir = logging_dir
        os.makedirs(logging_dir, exist_ok=True)
        self._metric_file = open(
            os.path.join(logging_dir, METRIC_LOG_FILE_NAME), "a")

    def log_metric(self, name, value, unit=None, global_step=None, extras=None):
        metric = _metric_dict(name, value, unit, global_step, extras)
        if metric is not None:
            self._metric_file.write(json.dumps(metric, sort_keys=True) + "\n")
            self._metric_file.flush()

    def log_run_info(self, run_info: Dict[str, Any]):
        path = os.path.join(self._logging_dir, BENCHMARK_RUN_LOG_FILE_NAME)
        with open(path, "a") as f:
            f.write(json.dumps(run_info, sort_keys=True, default=str) + "\n")

    def on_finish(self, status: str = "success"):
        self.log_metric("run_status", 1.0 if status == "success" else 0.0,
                        extras={"status": status})
        self._metric_file.close()


def get_benchmark_logger() -> BaseBenchmarkLogger:
    """The file logger when ``AUTODIST_BENCHMARK_LOG_DIR`` is set, else the
    base logger."""
    log_dir = const.ENV.AUTODIST_BENCHMARK_LOG_DIR.val
    if log_dir:
        return BenchmarkFileLogger(log_dir)
    return BaseBenchmarkLogger()


def gather_run_info(model_name: str, dataset_name: str = "synthetic",
                    strategy_name: str = "", batch_size: int = 0) -> Dict[str, Any]:
    """Environment and run metadata (reference logger.py:226-260): the
    torch and CUDA versions and the visible cards (platform ``gpu``), or
    platform ``cpu`` with no device kinds when there is no card."""
    import torch
    on_card = torch.cuda.is_available()
    count = torch.cuda.device_count() if on_card else 0
    return {
        "model_name": model_name,
        "dataset": {"name": dataset_name},
        "strategy": strategy_name,
        "batch_size": batch_size,
        "run_date": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "machine_config": {
            "platform": "gpu" if on_card else "cpu",
            "num_devices": count,
            "device_kinds": sorted({torch.cuda.get_device_name(i) for i in range(count)}),
        },
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def _metric_dict(name, value, unit, global_step, extras) -> Optional[Dict[str, Any]]:
    try:
        value = float(value)
    except (TypeError, ValueError):
        _log.warning("Metric %s has non-numeric value %r; dropped", name, value)
        return None
    ts = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    return {
        "name": name,
        "value": value,
        "unit": unit,
        "global_step": global_step,
        "timestamp": ts,
        "extras": extras or {},
    }


_MLPERF_DEFAULT_VERSION = "4.0.0"


def mlperf_log(key: str, value: Any = None, *, kind: str = "POINT_IN_TIME",
               version: str = _MLPERF_DEFAULT_VERSION,
               out: Optional[List[str]] = None) -> str:
    """One MLPerf-compliance log line (the public ``:::MLL`` convention).
    Returns the line; appends it to ``out`` when given, else logs it at
    INFO."""
    record = {
        "namespace": "",
        "time_ms": int(time.time() * 1000),
        "event_type": kind,
        "key": key,
        "value": value,
        "metadata": {"file": "", "lineno": 0, "mlperf_version": version},
    }
    line = ":::MLL " + json.dumps(record, sort_keys=True, default=str)
    if out is not None:
        out.append(line)
    else:
        _log.info("%s", line)
    return line
