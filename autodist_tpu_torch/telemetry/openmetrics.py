"""OpenMetrics/Prometheus exposition of the metrics registry.

The registry's ``snapshot()`` already crosses the PS wire, but only to
clients speaking this repo's codec. This module renders the SAME instruments
in the Prometheus text exposition format (version 0.0.4 — the format every
standard scraper, agent and gateway ingests) and serves it from a tiny
stdlib HTTP endpoint, so the whole stack becomes scrapeable with a
five-line scrape config and NO custom client:

- :func:`render` — zero-dependency text rendering straight off the live
  :class:`~autodist_tpu_torch.telemetry.metrics.Registry`: counters as
  ``<name>_total``, gauges verbatim, histograms as CUMULATIVE
  ``_bucket{le="..."}`` series plus ``_sum``/``_count`` (the registry's
  ``le``-bucket semantics are already Prometheus's — only the running total
  differs from the per-bucket snapshot form). Metric names sanitize
  ``a.b.c`` -> ``a_b_c``; HELP/label text is escaped per the spec.
- :class:`MetricsExporter` — a daemon-threaded ``ThreadingHTTPServer``
  answering ``GET /metrics`` (the exposition) and ``GET /healthz`` (a JSON
  liveness probe carrying uptime and the active-alert count). Attach points:
  the trainer chief (``train()``), ``PSServer`` and ``InferenceServer`` all
  call :func:`maybe_serve` — a process-global get-or-create keyed off
  ``AUTODIST_METRICS_PORT``, so a process with both a PS server and a train
  loop still binds ONE port.

Trust model: same as every transport here — the endpoint is read-only and
unauthenticated; it binds all interfaces (scrapers live off-host by
definition), so exposing it past the cluster's trust domain is the
operator's explicit choice of port.
"""

import http.server
import json
import threading
import time
from typing import Dict, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["render", "metric_name", "MetricsExporter", "maybe_serve",
           "get_exporter", "set_exporter", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def metric_name(name: str) -> str:
    """``ps.wire.bytes_sent`` -> ``ps_wire_bytes_sent``: the registry's
    dotted-lowercase convention mapped onto the exposition charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``); anything else becomes ``_``."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    if value != value:                    # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


def render(registry: Optional[_metrics.Registry] = None) -> str:
    """The full exposition for ``registry`` (default: the process-global
    one), deterministic for a given set of recorded values (names sorted —
    the same contract ``snapshot()`` keeps)."""
    reg = registry if registry is not None else _metrics.registry()
    lines = []
    for name, inst in reg.instruments():
        pname = metric_name(name)
        if isinstance(inst, _metrics.Counter):
            lines.append(f"# HELP {pname}_total {_escape_help(name)}")
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(inst.snapshot())}")
        elif isinstance(inst, _metrics.Gauge):
            lines.append(f"# HELP {pname} {_escape_help(name)}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(inst.snapshot())}")
        elif isinstance(inst, _metrics.Histogram):
            snap = inst.snapshot()
            lines.append(f"# HELP {pname} {_escape_help(name)}")
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound in inst.buckets:
                cum += snap[f"le:{bound:g}"]
                le = _escape_label(_fmt(float(bound)))
                lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{pname}_sum {_fmt(snap['sum'])}")
            lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + "\n" if lines else "\n"


class MetricsExporter:
    """The scrape endpoint: ``/metrics`` + ``/healthz`` on
    ``AUTODIST_METRICS_PORT`` (or an explicit ``port``; 0 binds ephemeral —
    the loopback tests' mode). One daemon accept thread, one handler thread
    per scrape (scrapes are rare and tiny; the render is a lock-guarded
    walk of the registry, never device work)."""

    def __init__(self, port: Optional[int] = None, host: str = "",
                 registry: Optional[_metrics.Registry] = None):
        if port is None:
            raw = str(const.ENV.AUTODIST_METRICS_PORT.val)
            port = int(raw) if raw else 0
        self._registry = registry
        self._t_started = time.monotonic()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = render(outer._registry).encode()
                    self._reply(200, CONTENT_TYPE, body)
                elif path == "/healthz":
                    body = json.dumps(outer.health()).encode()
                    self._reply(200, "application/json", body)
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass   # scrapes at scrape-interval rate must not spam logs

        class Server(http.server.ThreadingHTTPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="autodist-metrics-http")
        self._thread.start()
        logging.info("metrics exporter: /metrics + /healthz listening on "
                     ":%d", self.address[1])

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def health(self) -> Dict[str, object]:
        """The ``/healthz`` body: liveness plus the one number a probe can
        act on without parsing the exposition."""
        from autodist_tpu_torch.telemetry import alerts as _alerts
        return {"ok": True,
                "uptime_s": round(time.monotonic() - self._t_started, 3),
                "pid": const.ENV.AUTODIST_PROCESS_ID.val,
                "alerts_active": len(_alerts.active_alerts())}

    def close(self):
        self._server.shutdown()
        self._server.server_close()


_EXPORTER: Optional[MetricsExporter] = None
_EXPORTER_LOCK = san_lock()


def set_exporter(exporter: Optional[MetricsExporter]):
    """Install (or clear-and-close, with None) the process exporter."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        if _EXPORTER is not None and _EXPORTER is not exporter:
            _EXPORTER.close()
        _EXPORTER = exporter


def get_exporter() -> Optional[MetricsExporter]:
    return _EXPORTER


def maybe_serve() -> Optional[MetricsExporter]:
    """The attach hook every server/loop entry point calls: start the
    process exporter when ``AUTODIST_METRICS_PORT`` is set and none is
    running yet; no-op (None) otherwise. A failed bind (port taken — e.g.
    two processes on one host sharing an inherited env) warns and returns
    None: observability must never take down the thing it observes.
    ``AUTODIST_METRICS_PORT=0`` stays disabled (the flag convention for
    off); an EXPLICIT ``MetricsExporter(port=0)`` binds ephemeral — the
    loopback tests' mode."""
    global _EXPORTER
    raw = str(const.ENV.AUTODIST_METRICS_PORT.val)
    if not raw or raw == "0":
        return _EXPORTER
    with _EXPORTER_LOCK:
        if _EXPORTER is None:
            try:
                _EXPORTER = MetricsExporter(port=int(raw))
            except (OSError, ValueError) as e:
                logging.warning("metrics exporter: cannot serve on "
                                "AUTODIST_METRICS_PORT=%s: %s", raw, e)
                return None
        return _EXPORTER
