"""Fixed-bucket histograms (the port's copy of ``Histogram`` and
``COUNT_BUCKETS`` from ``autodist_tpu/telemetry/metrics.py:34,120-202``): the
staleness controller keeps its per-worker lag distributions in them. The
rest of that module (the registry, counters, gauges, events, exemplars)
waits for ``ROADMAP.md`` Queue 1 item 7."""

import bisect
import threading
from typing import Dict, Sequence, Tuple, Union

Number = Union[int, float]

# Integer-count edges (the staleness lag, in steps).
COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32)


class Histogram:
    """``observe(v)`` lands in the first bucket whose upper bound satisfies
    ``v <= bound`` (Prometheus ``le`` semantics), with an implicit ``+inf``
    overflow bucket; snapshots of the same edges merge by addition."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Sequence[Number] = COUNT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be non-empty and ascending, "
                             f"got {buckets!r}")
        self.name = name
        self.buckets: Tuple[Number, ...] = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum: float = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: Number):
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> Dict[str, Number]:
        """Per-bucket counts keyed ``le:<bound>`` (and ``le:+inf``), the
        total ``count`` and ``sum``."""
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
        """``{0:5,1:3,+inf:1}``: the non-empty buckets, for one-line logs."""
        with self._lock:
            counts = list(self._counts)
        labels = [f"{b:g}" for b in self.buckets] + ["+inf"]
        return "{" + ",".join(f"{lab}:{n}" for lab, n in zip(labels, counts) if n) + "}"
