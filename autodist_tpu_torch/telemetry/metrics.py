"""Process-global metrics registry: Counter / Gauge / Histogram.

The runtime previously had four disconnected accounting islands
(``WireCounters``, ``ThroughputMeter``, ad-hoc log fields, benchmark logger
rows); this registry gives them one namespace with a deterministic
``snapshot()`` that is wire-encodable (plain str/int/float/dict values), so
the PS ``stats`` opcode can ship a remote worker's or the chief's metrics
across the transport verbatim.

All instruments are lock-guarded and ``__slots__``-small; creation is
get-or-create by name so instrumentation sites never race registration.
Metric names are dotted lowercase (``ps.wire.bytes_sent``,
``train.readback_wait_s``) — the convention the docs and the stats plane
assume.
"""

import bisect
import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "counter", "gauge", "histogram", "snapshot", "event", "events",
           "family_buckets", "quantile", "merge_histograms"]

Number = Union[int, float]

# Default histogram bucket upper bounds for second-valued observations
# (latency-style: 1ms .. 10s, +inf implicit).
SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)
# For small-integer distributions (staleness lag, queue depths).
COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32)
# Millisecond-scale edges for online-serving latencies (0.5ms .. 2.5s): the
# step-time default above puts everything under 1ms in one bucket, which is
# where a whole loopback serving distribution lives.
MS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
              0.25, 0.5, 1.0, 2.5)
# Log-spaced edges for norm-valued observations (the training-health plane's
# gradient-norm distribution): healthy norms cluster around O(1); the decades
# on either side are where vanishing/exploding shows up.
NORM_BUCKETS = (0.001, 0.01, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 100.0,
                1000.0)

# Per-family default-bucket overrides, keyed by metric-name prefix (a family
# matches ``name == prefix`` or ``name.startswith(prefix + '.')``; the
# longest match wins). Histograms created WITHOUT explicit buckets resolve
# their family here, so e.g. every ``serve.latency_s.*`` instrument gets
# ms-scale edges without each call site repeating them. Names outside every
# family keep SECONDS_BUCKETS — the pre-existing default is unchanged.
BUCKET_FAMILIES: Dict[str, Tuple[Number, ...]] = {
    "serve.latency_s": MS_BUCKETS,
    "train.health.grad_norm": NORM_BUCKETS,
}


def family_buckets(name: str) -> Tuple[Number, ...]:
    """The default bucket edges for ``name``: its longest matching family in
    :data:`BUCKET_FAMILIES`, else :data:`SECONDS_BUCKETS`."""
    best: Optional[str] = None
    for prefix in BUCKET_FAMILIES:
        if (name == prefix or name.startswith(prefix + ".")) \
                and (best is None or len(prefix) > len(best)):
            best = prefix
    return BUCKET_FAMILIES[best] if best is not None else SECONDS_BUCKETS


class Counter:
    """Monotonically increasing sum (ints or floats)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: Number = 0
        self._lock = san_lock()

    def inc(self, n: Number = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value

    def snapshot(self) -> Number:
        return self._value


class Gauge:
    """Last-set instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: Number = 0
        self._lock = san_lock()

    def set(self, value: Number):
        with self._lock:
            self._value = value

    def inc(self, n: Number = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value

    def snapshot(self) -> Number:
        return self._value


EXEMPLAR_WINDOW_S = 300.0


class Histogram:
    """Fixed-bucket histogram: ``observe(v)`` lands in the first bucket whose
    upper bound satisfies ``v <= bound`` (Prometheus ``le`` semantics), with
    an implicit ``+inf`` overflow bucket. Bucket edges are fixed at
    construction — snapshots from different processes with the same edges
    merge by element-wise addition.

    Observation sites may attach an EXEMPLAR — a small wire-encodable dict
    identifying the concrete observation (a serving rid plus its phase
    breakdown). The histogram keeps only the SLOWEST exemplar of the last
    :data:`EXEMPLAR_WINDOW_S` seconds, so an alert firing on this histogram
    can name one traceable request instead of an anonymous quantile.
    Exemplars carry wall-clock time and live OUTSIDE :meth:`snapshot`
    (which stays deterministic); read them via :meth:`exemplar`."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock",
                 "_ex", "_ex_value", "_ex_t")

    def __init__(self, name: str, buckets: Sequence[Number] = SECONDS_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be non-empty and "
                             f"ascending, got {buckets!r}")
        self.name = name
        self.buckets: Tuple[Number, ...] = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self._sum: float = 0.0
        self._count = 0
        self._ex: Optional[Dict[str, object]] = None
        self._ex_value = 0.0
        self._ex_t = 0.0
        self._lock = san_lock()

    def observe(self, value: Number,
                exemplar: Optional[Dict[str, object]] = None):
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                now = time.time()
                if (value >= self._ex_value or self._ex is None
                        or now - self._ex_t > EXEMPLAR_WINDOW_S):
                    self._ex = dict(exemplar, value=float(value))
                    self._ex_value = float(value)
                    self._ex_t = now

    def exemplar(self) -> Optional[Dict[str, object]]:
        """The slowest exemplar observed within the last
        :data:`EXEMPLAR_WINDOW_S` seconds (a copy), else None."""
        with self._lock:
            if self._ex is None or time.time() - self._ex_t > EXEMPLAR_WINDOW_S:
                return None
            return dict(self._ex)

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> Dict[str, Number]:
        """Wire-encodable dict: per-bucket counts keyed ``le:<bound>`` (plus
        ``le:+inf``), total ``count`` and ``sum``."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out: Dict[str, Number] = {}
        for bound, n in zip(self.buckets, counts):
            out[f"le:{bound:g}"] = n
        out["le:+inf"] = counts[-1]
        out["count"] = total
        out["sum"] = s
        return out

    def format_compact(self) -> str:
        """``lag{0:5,1:3,+inf:1}``-style rendering of the NON-EMPTY buckets,
        for one-line log summaries (the per-worker ``PSServer closed:``
        breakdown)."""
        with self._lock:
            counts = list(self._counts)
        labels = [f"{b:g}" for b in self.buckets] + ["+inf"]
        body = ",".join(f"{l}:{n}" for l, n in zip(labels, counts) if n)
        return "{" + body + "}"


def quantile(hist: Dict[str, Number], q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a histogram SNAPSHOT dict (the
    ``le:<bound>`` + ``count`` wire form every histogram ships).

    This is the ONE bucket-interpolation everybody uses — the alert engine's
    burn-rate predicate, ``tools/adtop.py``'s serving SLO line, and
    ``tools/adfleet.py``'s fleet aggregation — so three consumers can never
    drift apart on what "p99" means. Linear interpolation inside the winning
    bucket (the first bucket's lower edge is 0, clamped to the edge when the
    edge is negative); a quantile landing in the ``+inf`` overflow bucket
    returns the largest finite edge — a LOWER bound, which is the honest
    answer a fixed-bucket histogram can give. Returns None for an empty
    histogram (or a non-histogram dict)."""
    try:
        total = hist["count"]
    except (TypeError, KeyError):
        return None
    if not total:
        return None
    edges = sorted((float(k[3:]), v) for k, v in hist.items()
                   if k.startswith("le:") and k != "le:+inf")
    target = max(0.0, min(1.0, q)) * total
    seen = 0.0
    lower = None
    for bound, n in edges:
        if n and seen + n >= target:
            lo = min(0.0, bound) if lower is None else lower
            return lo + (bound - lo) * (target - seen) / n
        seen += n
        lower = bound
    return edges[-1][0] if edges else None


def merge_histograms(snaps: Sequence[Dict[str, Number]]) -> Dict[str, Number]:
    """Element-wise sum of histogram snapshot dicts — the cross-process
    aggregation (identical edges merge exactly; a snapshot with different
    edges contributes its buckets verbatim, which keeps :func:`quantile`
    a defensible estimate rather than raising mid-console-render)."""
    out: Dict[str, Number] = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for k, v in snap.items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    return out


# Structured events kept per registry (newest win; anomaly records from the
# PS watchdog, not a general log sink).
_EVENT_RING = 256


class Registry:
    """Named get-or-create instrument store with a deterministic snapshot.

    Besides instruments, a registry keeps a bounded ring of STRUCTURED
    EVENTS (:meth:`event`) — discrete anomaly records like the PS watchdog's
    straggler flags, where a counter says "how many" but not "which worker,
    when". Events carry wall-clock timestamps, so they live OUTSIDE
    :meth:`snapshot` (which stays deterministic for a given set of recorded
    values); ship them explicitly via :meth:`events`."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._events = collections.deque(maxlen=_EVENT_RING)
        self._lock = san_lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[Number]] = None) -> Histogram:
        return self._get(name, Histogram, buckets or family_buckets(name))

    def get(self, name: str) -> Optional[object]:
        """The live instrument registered under ``name``, or None — a
        NON-CREATING lookup for consumers (the alert engine's exemplar
        attach) that must observe, never register."""
        with self._lock:
            return self._metrics.get(name)

    def instruments(self) -> List[Tuple[str, object]]:
        """A point-in-time, name-sorted copy of the live instrument objects
        — the public walk :meth:`snapshot` and the OpenMetrics renderer
        share (renderers need the instrument TYPE, which the snapshot's
        plain values erase)."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> Dict[str, object]:
        """``{name: value-or-histogram-dict}``, keys sorted — deterministic
        for a given set of recorded values regardless of registration order,
        and wire-encodable as-is (the ``stats`` opcode ships it)."""
        return {name: m.snapshot() for name, m in self.instruments()}

    def event(self, name: str, **fields) -> Dict[str, object]:
        """Record a structured event (``{"name", "t_wall_s", **fields}``) into
        the bounded event ring; returns the record. Field values must be
        wire-encodable plain data (the stats plane ships events verbatim)."""
        rec: Dict[str, object] = {"name": name,
                                  "t_wall_s": round(time.time(), 3)}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)
        return rec

    def events(self) -> List[Dict[str, object]]:
        """A point-in-time copy of the event ring, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self):
        """Drop every instrument and event (tests; production registries live
        for the process)."""
        with self._lock:
            self._metrics.clear()
            self._events.clear()

    def clear_events(self):
        """Drop the event ring only, keeping instruments — for consumers
        (tests, a snapshot-and-reset exporter) that need a clean anomaly
        window without discarding counters other subsystems still hold."""
        with self._lock:
            self._events.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-global registry every instrumented subsystem shares."""
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets: Optional[Sequence[Number]] = None) -> Histogram:
    return _REGISTRY.histogram(name, buckets)


def snapshot() -> Dict[str, object]:
    return _REGISTRY.snapshot()


def event(name: str, **fields) -> Dict[str, object]:
    return _REGISTRY.event(name, **fields)


def events() -> List[Dict[str, object]]:
    return _REGISTRY.events()
