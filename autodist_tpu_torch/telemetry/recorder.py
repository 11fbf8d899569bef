"""Flight recorder: anomaly-triggered capture of the whole telemetry plane.

Pod-scale practice treats stragglers, input stalls and loss blowups as
ROUTINE events that must be diagnosable after the fact, without a human
having had a profiler attached. The measurement plane (span rings, metrics
registry, cluster trace wire) already records everything needed — this module
snapshots it to disk at the moment an anomaly fires:

- :class:`FlightRecorder` writes SELF-CONTAINED snapshot dirs into a bounded
  latest-K ring (oldest evicted): a merged, Perfetto-loadable cluster trace
  (local ring + every worker ring deposited on the server, anomaly events
  overlaid as instant markers), the full metrics-registry snapshot, the event
  ring as JSONL (``tools/tracedump.py --events`` re-merges it), and an
  env/config manifest — everything the existing tracedump tooling reads.
- Triggers: the PS watchdog's ``ps.anomaly.{stall,straggler}`` events, the
  training-health monitors' ``health.anomaly`` events
  (:mod:`autodist_tpu_torch.telemetry.health`), the manual ``record`` wire opcode
  (``RemotePSWorker.record()``), or a direct :meth:`FlightRecorder.record`
  call. Automatic triggers are debounced (``AUTODIST_RECORDER_MIN_S``) so an
  anomaly storm costs one snapshot per window, not one per step.

Arming: :func:`set_recorder` installs a process recorder explicitly;
``AUTODIST_RECORDER=1`` arms a default one lazily at the first trigger.
Un-armed, :func:`maybe_record` is a no-op costing one global read + one env
check — monitoring must never tax the healthy path.
"""

import json
import os
import shutil
import socket
import sys
import threading
import time
from typing import Any, Dict, Iterable, Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import cluster as _cluster
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["FlightRecorder", "set_recorder", "get_recorder", "get_or_create",
           "maybe_record", "build_manifest"]

# Snapshot dir schema (pinned by tests): every snapshot contains exactly
# these entries, so downstream tooling can rely on the layout.
SNAPSHOT_FILES = ("manifest.json", "metrics.json", "events.jsonl",
                  "trace.json")
_SNAP_PREFIX = "snap-"


def build_manifest(reason: str, seq: Optional[int] = None) -> Dict[str, Any]:
    """The shared environment manifest (who/when/where/with-what-flags) every
    self-describing diagnostic artifact carries: flight-recorder snapshot
    dirs AND the profiling plane's per-run profile JSONs
    (:func:`autodist_tpu_torch.telemetry.profiling.write_profile`) — so adprof can
    say whether two profiles even came from comparable runs."""
    import numpy as np
    flags = {k: os.environ[k] for k in sorted(os.environ)  # graftlint: disable=GL007(the manifest dumps the RAW env value of every SET AUTODIST_* flag — a whole-registry diagnostic snapshot, not a typed single-flag read)
             if k.startswith("AUTODIST_")}
    manifest: Dict[str, Any] = {
        "reason": reason,
        "t_wall_s": round(time.time(), 3),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "process_id": const.ENV.AUTODIST_PROCESS_ID.val,
        "flags": flags,
        "versions": {"python": sys.version.split()[0],
                     "numpy": np.__version__},
    }
    if seq is not None:
        manifest["seq"] = seq
    try:
        # The device section: the card, torch and CUDA, where the JAX
        # package's names the JAX device.
        import torch
        manifest["versions"]["torch"] = torch.__version__
        manifest["versions"]["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            manifest["device"] = {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}
        else:
            manifest["device"] = {"platform": "cpu", "kind": "cpu", "count": 0}
    except Exception:   # torch-less diagnostics still snapshot
        pass
    try:
        # The applied execution plan (autotuner record: cache key + knobs +
        # predicted vs measured), when one was applied — a snapshot names
        # which plan the run it captured was executing.
        from autodist_tpu_torch.telemetry import profiling as _profiling
        plan = _profiling.applied_plan()
        if plan:
            manifest["plan"] = plan
    except Exception:   # diagnostics must never fail the snapshot
        pass
    try:
        # Active alerts at capture time (the non-creating accessor: a
        # snapshot must not grow an alert engine as a side effect) — an
        # alert-triggered snapshot carries WHICH rule fired and its numbers.
        from autodist_tpu_torch.telemetry import alerts as _alerts
        active = _alerts.active_alerts()
        if active:
            manifest["alerts"] = active
    except Exception:   # diagnostics must never fail the snapshot
        pass
    try:
        # Recovery actions so far (evictions/rejoins/rollbacks/respawns) —
        # an eviction- or rollback-triggered snapshot names what the
        # runtime already DID about the incident, not just what it saw.
        from autodist_tpu_torch.parallel import recovery as _recovery
        rec = _recovery.recovery_snapshot()
        if any((rec.get("counts") or {}).values()):
            manifest["recovery"] = rec
    except Exception:   # diagnostics must never fail the snapshot
        pass
    try:
        # The memory plane's forensics record: owner census, per-program
        # ledger, recent device.mem history and the predicted-vs-live peak
        # delta — an OOM-triggered snapshot names the dominant owner from
        # the manifest alone. Present when the plane is armed (claims
        # exist or spans are on); a stable empty shell otherwise.
        from autodist_tpu_torch.telemetry import memplane as _memplane
        manifest["memory"] = _memplane.memory_section()
    except Exception:   # diagnostics must never fail the snapshot
        pass
    return manifest


def _sanitize(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in reason)[:48] or "anomaly"


def _snap_seq(name: str) -> int:
    """The integer sequence number of a snapshot dir name, or -1 when the
    name does not parse (a foreign dir sorts first and evicts first)."""
    try:
        return int(name[len(_SNAP_PREFIX):].split("-", 1)[0])
    except ValueError:
        return -1


class FlightRecorder:
    """Bounded on-disk ring of telemetry snapshots.

    ``base_dir`` defaults to ``AUTODIST_RECORDER_DIR`` (falling back to
    ``<AUTODIST_WORKING_DIR>/flightrec``); ``keep`` and ``min_interval_s``
    default to ``AUTODIST_RECORDER_KEEP`` / ``AUTODIST_RECORDER_MIN_S``.
    :meth:`record` always captures; :meth:`maybe_record` (the automatic
    triggers' entry point) honors the debounce window. Thread-safe: the
    watchdog thread and the train loop may trigger concurrently — the lock
    covers only sequencing/debounce bookkeeping, never the file writes."""

    def __init__(self, base_dir: Optional[str] = None,
                 keep: Optional[int] = None,
                 min_interval_s: Optional[float] = None):
        env_dir = str(const.ENV.AUTODIST_RECORDER_DIR.val)
        self.base_dir = base_dir or env_dir \
            or os.path.join(const.DEFAULT_WORKING_DIR, "flightrec")
        self.keep = max(1, int(const.ENV.AUTODIST_RECORDER_KEEP.val
                               if keep is None else keep))
        self.min_interval_s = float(const.ENV.AUTODIST_RECORDER_MIN_S.val
                                    if min_interval_s is None
                                    else min_interval_s)
        self._lock = san_lock()
        self._last_record = -float("inf")
        self._seq = self._next_seq()

    def _next_seq(self) -> int:
        """Resume numbering past any snapshots already on disk, so a
        restarted process extends the ring instead of overwriting it."""
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return 0
        seqs = [_snap_seq(n) for n in names if n.startswith(_SNAP_PREFIX)]
        seqs = [s for s in seqs if s >= 0]
        return max(seqs) + 1 if seqs else 0

    def snapshots(self) -> list:
        """Snapshot dir paths on disk, oldest first (NUMERIC sequence order —
        a lexicographic sort would classify ``snap-10000`` as older than
        ``snap-9999`` and :meth:`_evict` would delete the newest snapshot the
        moment the counter grows a digit)."""
        try:
            names = [n for n in os.listdir(self.base_dir)
                     if n.startswith(_SNAP_PREFIX)]
        except OSError:
            return []
        return [os.path.join(self.base_dir, n)
                for n in sorted(names, key=lambda n: (_snap_seq(n), n))]

    def maybe_record(self, reason: str, server=None,
                     peers: Iterable = ()) -> Optional[str]:
        """The automatic-trigger entry point: capture unless the last
        snapshot is younger than ``min_interval_s`` (returns None then)."""
        return self._capture(reason, server, peers, debounced=True)

    def record(self, reason: str, server=None,
               peers: Iterable = ()) -> Optional[str]:
        """Capture one snapshot NOW (manual triggers bypass the debounce);
        returns the snapshot dir, or None when the write failed (a broken
        disk must not take down the run being diagnosed).

        ``server`` (a PSServer) contributes every worker ring deposited via
        ``push_trace``; ``peers`` are objects with a ``trace()`` method to
        pull live rings from. The local span ring is always lane 0."""
        return self._capture(reason, server, peers, debounced=False)

    def _capture(self, reason: str, server, peers,
                 debounced: bool) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            # Check AND claim the debounce window in ONE critical section:
            # the watchdog thread and the train loop's health boundary may
            # trigger within microseconds of each other, and both passing a
            # check-then-stamp-later window would write two snapshots.
            if debounced and now - self._last_record < self.min_interval_s:
                return None
            prev_last = self._last_record
            self._last_record = now
            seq = self._seq
            self._seq += 1
        # The process id is part of the dir name: multi-process runs share
        # the default base dir, and each process numbers its own sequence —
        # without the lane tag two processes would clobber one snap-NNNN
        # (the host_spans_w<id> collision class).
        proc = int(const.ENV.AUTODIST_PROCESS_ID.val)
        path = os.path.join(
            self.base_dir,
            f"{_SNAP_PREFIX}{seq:04d}-w{proc}-{_sanitize(reason)}")
        try:
            os.makedirs(path, exist_ok=True)
            events = _metrics.events()
            self._write_manifest(path, reason, seq)
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(_metrics.snapshot(), f, indent=1, default=str)
            _cluster.dump_events_jsonl(
                os.path.join(path, "events.jsonl"), events=events)
            self._write_trace(path, server, peers, events)
        except (OSError, ValueError, TypeError) as e:
            with self._lock:
                if self._last_record == now:   # no later capture claimed it
                    # Roll the debounce claim back: a transient write failure
                    # must not suppress the NEXT anomaly's snapshot for a
                    # whole min_interval_s window.
                    self._last_record = prev_last
            logging.warning("flight recorder: snapshot %r failed: %s",
                            reason, e)
            return None
        self._evict()
        logging.info("flight recorder: wrote snapshot %s (%s)", path, reason)
        return path

    def _write_manifest(self, path: str, reason: str, seq: int):
        manifest = build_manifest(reason, seq=seq)
        manifest["files"] = list(SNAPSHOT_FILES)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    def _write_trace(self, path: str, server, peers, events):
        states = [_cluster.local_trace_state()]
        for peer in peers:
            try:
                states.append(peer.trace())
            except Exception as e:   # a dead peer must not sink the snapshot
                logging.debug("flight recorder: peer trace pull failed: %s", e)
        if server is not None:
            try:
                for _, st in sorted(server.worker_traces().items(),
                                    key=lambda kv: str(kv[0])):
                    states.append(st)
            except Exception as e:
                logging.debug("flight recorder: worker traces unavailable: "
                              "%s", e)
        _cluster.merge_trace_states(states, os.path.join(path, "trace.json"),
                                    instant_events=events)

    def _evict(self):
        snaps = self.snapshots()
        for old in snaps[:max(0, len(snaps) - self.keep)]:
            try:
                shutil.rmtree(old)
            except OSError as e:
                logging.debug("flight recorder: evicting %s failed: %s",
                              old, e)


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = san_lock()


def set_recorder(recorder: Optional[FlightRecorder]):
    """Install (or clear, with None) the process's flight recorder — the
    automatic triggers (watchdog, health monitors) record through it."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = recorder


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def get_or_create() -> FlightRecorder:
    """The installed recorder, or a fresh env-default one installed on the
    spot (the manual ``record`` opcode and ``action=record`` monitors must
    succeed without prior arming)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def maybe_record(reason: str, server=None,
                 peers: Iterable = ()) -> Optional[str]:
    """Automatic-trigger hook: record (debounced) through the installed
    recorder; with none installed, arm one only when ``AUTODIST_RECORDER``
    says so, else no-op. The un-armed cost is one global read + one env
    check — cheap enough for every watchdog tick and health boundary."""
    rec = _RECORDER
    if rec is None:
        if not const.ENV.AUTODIST_RECORDER.val:
            return None
        rec = get_or_create()
    return rec.maybe_record(reason, server=server, peers=peers)
