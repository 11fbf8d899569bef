"""The port's runtime telemetry (its copy of ``autodist_tpu/telemetry``):
host-side span tracing, a process-global metrics registry, and the planes
built on them, under the JAX package's names, file names, schemas and wire
replies, so the JAX package's tools (``tools/adtop.py``, ``adprof.py``,
``adfleet.py``, ``tracedump.py``) read what the port writes.

- **Spans** (:mod:`.spans`) and the **registry** (:mod:`.metrics`): a
  bounded ring of ``telemetry.span("name")`` records, Chrome trace-event
  export, counters, gauges, histograms and events whose ``snapshot()``
  wire-encodes as the JAX package's; ``emit_metrics()`` rides the benchmark
  logger's JSONL sink.
- **Cluster trace** (:mod:`.cluster`, :mod:`.reqtrace`): span rings cross
  the PS wire (``trace``/``push_trace``, ``ping`` clock offsets) and merge
  into one clock-aligned Chrome trace with a ``pid`` lane a worker.
- **Training health** (:mod:`.health`): ``AUTODIST_HEALTH=1`` computes a
  four-scalar bundle (non-finite count, grad, update and param norms) on
  the card inside the step, read only at ``train()``'s log boundaries,
  with a loss-spike monitor; ``AUTODIST_HEALTH_ACTION`` warns, records,
  halts or recovers (rolls back to the newest good snapshot).
- **Flight recorder** (:mod:`.recorder`): latest-K snapshot directories of
  the cluster trace, metrics, events and the manifest.
- **Attribution** (:mod:`.profiling`, :mod:`.costmodel`):
  ``AUTODIST_PROFILE=1`` keeps a cost record a step signature (the
  runner's ``plan_costs``, a trace on fake tensors, where the JAX package
  reads XLA's cost analysis), splits each log period into ``train.attr.*``
  shares, books ``train.mfu`` and ``train.membw_util`` against
  :func:`peak_spec`'s H100 rows, and writes the per-run profile
  (``AUTODIST_PROFILE_DIR``) the autotuner calibrates from.
- **Fleet metrics** (:mod:`.history`, :mod:`.openmetrics`, :mod:`.alerts`):
  ``AUTODIST_METRICS_DIR`` history shards, ``/metrics`` and ``/healthz``
  on ``AUTODIST_METRICS_PORT``, declarative alert rules.
- **Memory** (:mod:`.memplane`): an owner-attributed census of the card's
  allocated bytes, the budget the autotuner's pre-flight shares, pressure,
  and OOM forensics on ``torch.cuda.OutOfMemoryError``.

Divergences from the JAX package, each stated in its module:
``device.live_bytes`` is the caching allocator's allocated bytes (PyTorch
has no ``jax.live_arrays()``); program costs come from fake-tensor traces;
the ``jit.*`` counters count the port's builds of a step signature (its
first eager call, or a graph capture); graph dumps are FX graphs
(``utils/tracing.py``); the peak table holds H100 rows only.

Everything is OFF by default; ``AUTODIST_TELEMETRY=1`` (or
:func:`telemetry.enable`) turns recording on. A disabled span costs one
attribute check; a runner without health makes no extra launch.
"""

from autodist_tpu_torch.telemetry import (alerts, history, memplane, openmetrics,
                                    reqtrace)
from autodist_tpu_torch.telemetry.alerts import (AlertEngine, AlertHalt,
                                           AlertRecover, AlertRule)
from autodist_tpu_torch.telemetry.cluster import (collect_cluster_trace,
                                            dump_events_jsonl,
                                            dump_reqtrace_jsonl,
                                            dump_spans_jsonl,
                                            load_events_jsonl,
                                            load_reqtrace_jsonl,
                                            load_trace_jsonl,
                                            local_reqtrace_state,
                                            local_trace_state,
                                            merge_trace_states, ntp_offset,
                                            reqtrace_marks)
from autodist_tpu_torch.telemetry.export import (chrome_trace_events, emit_metrics,
                                           export_chrome_trace,
                                           opt_state_bytes,
                                           sample_device_memory)
from autodist_tpu_torch.telemetry.health import (HealthConfig, HealthHalt,
                                           HealthMonitor, HealthRecover)
from autodist_tpu_torch.telemetry.history import MetricsHistory
from autodist_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                            Registry, counter, event, events,
                                            gauge, histogram, merge_histograms,
                                            quantile, registry, snapshot)
from autodist_tpu_torch.telemetry.openmetrics import MetricsExporter
from autodist_tpu_torch.telemetry import costmodel, profiling
from autodist_tpu_torch.telemetry.profiling import (peak_spec, profile_document,
                                              write_profile)
from autodist_tpu_torch.telemetry.recorder import (FlightRecorder, build_manifest,
                                             get_recorder, maybe_record,
                                             set_recorder)
from autodist_tpu_torch.telemetry.spans import (clear, disable, enable, enabled,
                                          snapshot_spans, span, traced)

__all__ = [
    "span", "traced", "enable", "disable", "enabled", "clear",
    "snapshot_spans",
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "registry", "snapshot",
    "event", "events",
    "export_chrome_trace", "chrome_trace_events", "emit_metrics",
    "sample_device_memory", "opt_state_bytes",
    "collect_cluster_trace", "local_trace_state", "merge_trace_states",
    "dump_spans_jsonl", "load_trace_jsonl", "ntp_offset",
    "dump_events_jsonl", "load_events_jsonl",
    "reqtrace", "local_reqtrace_state", "reqtrace_marks",
    "dump_reqtrace_jsonl", "load_reqtrace_jsonl",
    "HealthConfig", "HealthHalt", "HealthMonitor", "HealthRecover",
    "FlightRecorder", "set_recorder", "get_recorder", "maybe_record",
    "build_manifest",
    "profiling", "costmodel", "peak_spec", "profile_document",
    "write_profile",
    "alerts", "history", "memplane", "openmetrics",
    "AlertEngine", "AlertHalt", "AlertRecover", "AlertRule",
    "MetricsHistory",
    "MetricsExporter", "quantile", "merge_histograms",
]
