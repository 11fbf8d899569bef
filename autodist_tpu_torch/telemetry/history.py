"""Metric history: the registry finally gets a time axis.

Every signal PRs 4–9 built (wire counters, staleness lags, SLO latency
histograms, ``train.attr.*`` shares, MFU) is a point-in-time ``snapshot()``
— nothing retains what a gauge read five minutes ago, so nothing can answer
"has data_wait been drifting up since the topology change?". This module
keeps that series:

- :class:`MetricsHistory` samples the process-global registry into a bounded
  in-memory ring of timestamped snapshots, and — when ``AUTODIST_METRICS_DIR``
  names a directory — appends each sample as one JSONL line into
  rotation-capped shard files, so the series survives the process and a
  sidecar can tail it.
- Sampling rides EXISTING beats, never a new hot path: the train loops call
  :func:`maybe_sample` at their log boundaries (where ``emit_metrics``
  already runs), the serving batcher's scheduler loop calls it between
  rounds, and an optional wall-clock thread (``AUTODIST_METRICS_INTERVAL_S``,
  bounded ``Event.wait`` — GL005-clean) covers processes with neither beat.
  :func:`maybe_sample` throttles to at most one sample per
  ``min_interval_s``, so a 5 ms-boundary loop cannot write a snapshot per
  period.
- Each sample is also the alert engine's evaluation tick
  (:mod:`autodist_tpu_torch.telemetry.alerts`): rules see the fresh sample plus the
  whole ring (for-duration and burn-rate windows need exactly this history).

Un-armed cost (the default): :func:`maybe_sample` is one module-global read
per call. Arming: :func:`set_history`, or any of ``AUTODIST_METRICS_DIR`` /
``AUTODIST_METRICS_INTERVAL_S`` / ``AUTODIST_ALERT_RULES`` set in the
environment (resolved once, at the first call).
"""

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock, san_event

__all__ = ["MetricsHistory", "set_history", "get_history", "get_or_create",
           "maybe_sample", "load_history_jsonl"]

# One shard file holds at most this many samples before rotation opens the
# next one; at the 10s default interval a shard is ~2.8h of history.
DEFAULT_SHARD_LINES = 1024
# Latest-K shards kept per process (older ones deleted at rotation).
DEFAULT_KEEP_SHARDS = 8
_SHARD_PREFIX = "metrics-"


def _shard_seq(name: str, prefix: str) -> int:
    """The numeric sequence of ``metrics-<seq>-w<proc>-p<pid>.jsonl``; -1
    when the name does not parse (foreign files sort first, evict never —
    they fail the per-process tag filter)."""
    try:
        return int(name[len(prefix):].split("-", 1)[0])
    except ValueError:
        return -1


class MetricsHistory:
    """Bounded ring of timestamped registry snapshots + JSONL shard store.

    ``ring`` bounds the in-memory series; ``out_dir`` (default
    ``AUTODIST_METRICS_DIR``; empty = memory-only) receives rotation-capped
    JSONL shards named ``metrics-<seq>-w<proc>-p<pid>.jsonl`` (the
    seq-first/pid-tagged scheme the flight recorder uses, so concurrent
    processes sharing a dir never clobber each other and eviction sorts
    numerically). ``min_interval_s`` (default ``AUTODIST_METRICS_INTERVAL_S``,
    falling back to 10s) throttles :meth:`maybe_sample`; :meth:`sample`
    always samples. ``engine`` is the alert engine evaluated on every sample
    (default: the process engine from :mod:`telemetry.alerts`; pass
    ``engine=False`` for a history with no alerting).

    Thread-safe: the train loop, the serving scheduler thread, and the
    wall-clock thread may all call into one history — the lock covers the
    ring and shard bookkeeping, never the alert engine's reaction (which
    must be free to capture a flight-recorder snapshot)."""

    def __init__(self, out_dir: Optional[str] = None,
                 ring: int = 512,
                 min_interval_s: Optional[float] = None,
                 shard_lines: int = DEFAULT_SHARD_LINES,
                 keep_shards: int = DEFAULT_KEEP_SHARDS,
                 engine: Any = None):
        env_dir = str(const.ENV.AUTODIST_METRICS_DIR.val)
        self.out_dir = env_dir if out_dir is None else out_dir
        self.ring = max(1, int(ring))
        if min_interval_s is None:
            min_interval_s = float(const.ENV.AUTODIST_METRICS_INTERVAL_S.val
                                   or 0.0) or 10.0
        self.min_interval_s = float(min_interval_s)
        self.shard_lines = max(1, int(shard_lines))
        self.keep_shards = max(1, int(keep_shards))
        if engine is None:
            from autodist_tpu_torch.telemetry import alerts as _alerts
            engine = _alerts.get_or_create()
        self.engine = engine or None    # engine=False -> no alerting
        self._samples: collections.deque = collections.deque(maxlen=self.ring)
        self._lock = san_lock()
        self._last_sample = -float("inf")
        proc = int(const.ENV.AUTODIST_PROCESS_ID.val)
        self._shard_tag = f"w{proc}-p{os.getpid()}.jsonl"
        self._shard_seq = self._next_shard_seq()
        self._shard_path: Optional[str] = None
        self._shard_count = 0
        self._warned_write = False
        self._stop = san_event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- sampling

    def sample(self, step: Optional[int] = None,
               reason: str = "manual") -> Dict[str, Any]:
        """Take one sample NOW: snapshot the registry, append to the ring
        (and the JSONL shard when armed), then evaluate the alert rules on
        the updated history. Returns the sample record. An
        :class:`~autodist_tpu_torch.telemetry.alerts.AlertHalt` from the engine
        (``AUTODIST_ALERT_ACTION=halt``) propagates to the caller — the
        train loop is the sampler that can actually stop a run; background
        threads catch it themselves."""
        now = time.monotonic()
        rec: Dict[str, Any] = {
            "t_wall_s": round(time.time(), 3),
            "t_mono_s": now,
            "reason": reason,
            "metrics": _metrics.snapshot(),
        }
        if step is not None:
            rec["step"] = int(step)
        with self._lock:
            self._last_sample = now
            self._samples.append(rec)
        self._append_shard(rec)
        if self.engine is not None:
            self.engine.evaluate(self)
        return rec

    def maybe_sample(self, step: Optional[int] = None,
                     reason: str = "boundary") -> Optional[Dict[str, Any]]:
        """The hot-path entry point: sample unless the last sample is younger
        than ``min_interval_s`` (returns None then). Check-and-claim runs in
        one critical section — two boundary threads racing the window write
        one sample, not two."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_sample < self.min_interval_s:
                return None
            self._last_sample = now
        return self.sample(step=step, reason=reason)

    # ----------------------------------------------------------------- queries

    def samples(self) -> List[Dict[str, Any]]:
        """A point-in-time copy of the ring, oldest first."""
        with self._lock:
            return list(self._samples)

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def window(self, seconds: float,
               now: Optional[float] = None) -> List[Dict[str, Any]]:
        """The samples of the last ``seconds`` (monotonic clock), oldest
        first — what the for-duration and burn-rate predicates evaluate."""
        now = time.monotonic() if now is None else now
        cut = now - seconds
        with self._lock:
            return [s for s in self._samples if s["t_mono_s"] >= cut]

    def series(self, name: str,
               window_s: Optional[float] = None) -> List[Tuple[float, Any]]:
        """``[(t_wall_s, value), ...]`` for one metric across the ring (or
        the last ``window_s`` seconds) — the "a gauge finally has a series"
        query. Samples missing the metric are skipped."""
        src = self.samples() if window_s is None else self.window(window_s)
        out = []
        for s in src:
            v = s["metrics"].get(name)
            if v is not None:
                out.append((s["t_wall_s"], v))
        return out

    # -------------------------------------------------------------- JSONL store

    def _next_shard_seq(self) -> int:
        """Resume shard numbering past this process's existing shards (a
        restarted run extends its history instead of clobbering it)."""
        if not self.out_dir:
            return 0
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return 0
        seqs = [_shard_seq(n, _SHARD_PREFIX) for n in names
                if n.startswith(_SHARD_PREFIX)]
        seqs = [s for s in seqs if s >= 0]
        return max(seqs) + 1 if seqs else 0

    def shards(self) -> List[str]:
        """THIS process's shard files on disk, oldest (numeric seq) first."""
        if not self.out_dir:
            return []
        try:
            names = [n for n in os.listdir(self.out_dir)
                     if n.startswith(_SHARD_PREFIX)
                     and n.endswith(self._shard_tag)]
        except OSError:
            return []
        return [os.path.join(self.out_dir, n)
                for n in sorted(names, key=lambda n: (_shard_seq(
                    n, _SHARD_PREFIX), n))]

    def _append_shard(self, rec: Dict[str, Any]):
        if not self.out_dir:
            return
        with self._lock:
            if self._shard_path is None or self._shard_count >= self.shard_lines:
                self._shard_path = os.path.join(
                    self.out_dir,
                    f"{_SHARD_PREFIX}{self._shard_seq:04d}-{self._shard_tag}")
                self._shard_seq += 1
                self._shard_count = 0
                rotate = True
            else:
                rotate = False
            path = self._shard_path
            self._shard_count += 1
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
            if rotate:
                self._evict_shards()
        except (OSError, ValueError, TypeError) as e:
            if not self._warned_write:   # a broken disk warns once, not per tick
                self._warned_write = True
                logging.warning("metrics history: shard write to %s failed: "
                                "%s (suppressing further warnings)", path, e)

    def _evict_shards(self):
        shards = self.shards()
        for old in shards[:max(0, len(shards) - self.keep_shards)]:
            try:
                os.remove(old)
            except OSError as e:
                logging.debug("metrics history: evicting %s failed: %s",
                              old, e)

    # ------------------------------------------------------- wall-clock thread

    def start_thread(self, interval_s: Optional[float] = None):
        """Start the optional wall-clock sampler: one daemon thread taking a
        sample every ``interval_s`` (default ``min_interval_s``) — the beat
        for processes with no train loop or scheduler round (a PS chief
        between applies). Bounded ``Event.wait`` per tick; idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return
        interval = float(interval_s if interval_s is not None
                         else self.min_interval_s)
        interval = max(0.1, interval)

        def _loop():
            from autodist_tpu_torch.telemetry import alerts as _alerts
            while not self._stop.wait(timeout=interval):   # bounded (GL005)
                try:
                    self.maybe_sample(reason="timer")
                except _alerts.AlertHalt as e:
                    # halt stops a LOOP; this thread owns none. Keep the
                    # evidence loud and keep sampling — the alert gauges and
                    # events are already booked for whoever polls status.
                    logging.warning("metrics history: %s (AUTODIST_ALERT_"
                                    "ACTION=halt has no training loop to "
                                    "stop in this process)", e)
                except Exception as e:   # a sick sampler must not die silent
                    logging.warning("metrics history: timer sample failed: "
                                    "%s", e)

        self._stop.clear()
        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="autodist-metrics-history")
        self._thread.start()

    def close(self):
        """Stop the wall-clock thread (when running). The ring and shards
        stay — history outlives its sampler."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


# ------------------------------------------------------------ process global

_HISTORY: Optional[MetricsHistory] = None
_HISTORY_LOCK = san_lock()
# Tri-state env-arming cache: None = not yet checked, False = checked and
# unarmed (maybe_sample stays a two-read no-op), True = armed.
_ENV_ARMED: Optional[bool] = None


def set_history(history: Optional[MetricsHistory]):
    """Install (or clear, with None) the process history the boundary hooks
    sample through. Clearing also resets the env-arming cache so tests that
    set ``AUTODIST_METRICS_DIR`` after a clear re-arm."""
    global _HISTORY, _ENV_ARMED
    with _HISTORY_LOCK:
        if _HISTORY is not None and _HISTORY is not history:
            _HISTORY.close()
        _HISTORY = history
        _ENV_ARMED = None


def get_history() -> Optional[MetricsHistory]:
    return _HISTORY


def _env_arms() -> bool:
    return bool(str(const.ENV.AUTODIST_METRICS_DIR.val)
                or float(const.ENV.AUTODIST_METRICS_INTERVAL_S.val or 0.0) > 0
                or str(const.ENV.AUTODIST_ALERT_RULES.val))


def get_or_create() -> MetricsHistory:
    """The installed history, or a fresh env-default one installed on the
    spot (with the wall-clock thread started when
    ``AUTODIST_METRICS_INTERVAL_S`` asks for one)."""
    global _HISTORY
    with _HISTORY_LOCK:
        if _HISTORY is None:
            _HISTORY = MetricsHistory()
            if float(const.ENV.AUTODIST_METRICS_INTERVAL_S.val or 0.0) > 0:
                _HISTORY.start_thread()
        return _HISTORY


def maybe_arm() -> Optional[MetricsHistory]:
    """Arm from the environment WITHOUT taking a sample — the attach hook
    for processes with no natural sampling beat (a PSServer chief between
    applies calls this from its constructor): when the flags say so, the
    history is installed and — with ``AUTODIST_METRICS_INTERVAL_S`` > 0 —
    its wall-clock sampler thread becomes the beat. Returns the installed
    history, or None when the environment leaves the plane off. A typo'd
    flag (``AUTODIST_METRICS_INTERVAL_S=abc``) DISARMS with a warning —
    this runs lazily inside loops the plane must never kill."""
    global _ENV_ARMED
    h = _HISTORY
    if h is not None:
        return h
    if _ENV_ARMED is False:
        return None
    try:
        if _ENV_ARMED is None:
            armed = _env_arms()
            with _HISTORY_LOCK:
                _ENV_ARMED = armed
            if not armed:
                return None
        return get_or_create()
    except (ValueError, TypeError, OSError) as e:
        logging.warning("metrics history: cannot arm from the "
                        "environment (%s); metric history is DISABLED "
                        "for this process", e)
        with _HISTORY_LOCK:
            _ENV_ARMED = False
        return None


def maybe_sample(step: Optional[int] = None, reason: str = "boundary",
                 force: bool = False) -> Optional[Dict[str, Any]]:
    """The boundary hook: throttled sample through the installed history;
    with none installed, arm one only when the environment says so
    (``AUTODIST_METRICS_DIR`` / ``AUTODIST_METRICS_INTERVAL_S`` /
    ``AUTODIST_ALERT_RULES``), else no-op. Un-armed steady-state cost: two
    module-global reads — cheap enough for every serving scheduler round.
    ``force=True`` (the end-of-run flush) bypasses the throttle so a short
    run still leaves at least one sample."""
    h = _HISTORY
    if h is None:
        h = maybe_arm()
        if h is None:
            return None
    if force:
        return h.sample(step=step, reason=reason)
    return h.maybe_sample(step=step, reason=reason)


def load_history_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read one shard file back into sample records (tooling / tests — the
    on-disk mirror of :meth:`MetricsHistory.samples`). Raises ``ValueError``
    on a line that is not a sample record."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not isinstance(rec, dict) or "metrics" not in rec:
                raise ValueError(f"{path}:{i + 1}: not a metrics-history "
                                 f"sample record")
            out.append(rec)
    return out
