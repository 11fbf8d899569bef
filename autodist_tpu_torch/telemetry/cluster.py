"""Cluster trace plane: clock-aligned multi-worker host timelines.

The span ring (:mod:`autodist_tpu_torch.telemetry.spans`) answers "what did THIS
process do"; at pod scale the question is "what did the CLUSTER do during one
step" — which worker's gate wait, input stall, or compile is the bottleneck.
This module makes span rings portable and mergeable:

- :func:`local_trace_state` snapshots the ring as a COLUMNAR, wire-encodable
  blob (name/tid tables + int32 index columns + int64 ``t0_ns``/``dur_ns``
  arrays): 65536 spans ship as a handful of large ndarrays the zero-copy PS
  wire frames without per-span Python encoding — that is what keeps a
  full-ring pull off the chief's critical path (``bench.py
  --trace-pull-overhead`` gates it).
- The PS transport's ``trace`` opcode serves this blob on demand and
  ``push_trace`` lets a worker deposit its own ring on the chief
  (:mod:`autodist_tpu_torch.parallel.ps_transport`); ``ping`` round-trips feed
  :func:`ntp_offset`, the NTP-style chief-clock offset estimate each worker
  stores per connection.
- :func:`collect_cluster_trace` (chief) / :func:`merge_trace_states` merge
  any set of blobs into ONE Chrome trace-event file with a ``pid`` lane per
  worker, every lane rebased onto the chief's wall clock via each blob's
  ``clock_offset_ns`` — loadable in Perfetto beside a ``torch.profiler``
  device trace.
- :func:`dump_spans_jsonl` / :func:`load_trace_jsonl` are the offline path:
  per-worker JSONL ring dumps that ``tools/tracedump.py`` merges after the
  run, when no transport was up to push through.

Clock model: spans are stamped with ``time.perf_counter_ns`` (monotonic,
process-local origin). Each blob carries one ``(wall_ns, perf_ns)`` pair
sampled back-to-back under the ring lock, so a span's wall-clock start is
``wall_ns + (t0_ns - perf_ns)``; adding the blob's ``clock_offset_ns``
(estimated as chief-clock minus local-clock, see :func:`ntp_offset`) lands it
on the chief's timeline. Offset uncertainty is bounded by half the best
observed ping RTT — microseconds on loopback, sub-millisecond on a pod's
DCN, far below the millisecond-scale spans the plane exists to compare.
"""

import json
import socket
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.telemetry import reqtrace as _reqtrace
from autodist_tpu_torch.telemetry import spans as _spans
from autodist_tpu_torch.utils import logging

__all__ = ["local_trace_state", "ntp_offset", "trace_state_events",
           "merge_trace_states", "collect_cluster_trace", "dump_spans_jsonl",
           "load_trace_jsonl", "dump_events_jsonl", "load_events_jsonl",
           "local_reqtrace_state", "reqtrace_marks", "reqtrace_trace_events",
           "dump_reqtrace_jsonl", "load_reqtrace_jsonl"]

# Trace-blob schema version (bumped on layout changes so an old tracedump
# rejects a new dump instead of misreading it).
TRACE_STATE_VERSION = 1

# Request-trace blob schema version (the `reqtrace` opcode's payload and the
# offline reqtrace JSONL dumps both carry it).
REQTRACE_STATE_VERSION = 1

_PLAIN = frozenset((str, int, float, bool, type(None)))


def _sanitize_args(args: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Span args restricted to wire/JSON-safe scalars (anything else rides as
    ``str(value)`` — a span arg must never make a ring unshippable)."""
    if not args:
        return None
    return {str(k): (v if type(v) in _PLAIN else str(v))
            for k, v in args.items()}


def _args_json(args_map: Dict[int, Dict[str, Any]]) -> str:
    """The sparse ``{span_index: args}`` map as ONE JSON string: C-speed
    serialization instead of thousands of nested wire dicts (a full-ring
    blob with per-step annotations would otherwise dominate the pull's
    chief-side stall — the ``bench.py --trace-pull-overhead`` gate)."""
    try:
        return json.dumps(args_map, default=str)
    except (TypeError, ValueError):
        # Pathological args (non-str/int dict keys etc.): sanitize per entry.
        return json.dumps({i: _sanitize_args(a)
                           for i, a in args_map.items()}, default=str)


def _parse_args_json(state: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
    """The blob's sparse args map with int span indices restored (JSON and
    the typed wire both stringify/accept the keys differently)."""
    raw = state.get("args_json")
    parsed = json.loads(raw) if raw else {}
    return {int(k): v for k, v in parsed.items()}


def local_trace_state(since_ns: Optional[int] = None,
                      worker_id: Optional[int] = None,
                      clock_offset_ns: int = 0) -> Dict[str, Any]:
    """Snapshot this process's span ring as a wire-encodable columnar blob.

    ``since_ns`` (a ``perf_counter_ns`` stamp) keeps only spans started
    at/after it; ``worker_id`` labels the blob's lane in a merged trace;
    ``clock_offset_ns`` is the chief-minus-local clock offset the holder
    estimated (0 for the chief itself). Columns: ``names``/``tids`` are
    de-duplicated tables, ``name_idx``/``tid_idx`` int32 index columns,
    ``t0_ns``/``dur_ns`` int64, sparse span args as one JSON string. The
    span ring is stored columnar with interned ids
    (:mod:`autodist_tpu_torch.telemetry.spans`), so a full 65536-span ring
    snapshots + encodes in tens of milliseconds — no per-span Python tuples
    anywhere between the ring and the wire — which is what keeps a live
    trace pull off the chief's critical path (``bench.py
    --trace-pull-overhead`` gates it)."""
    (pid, epoch_ns, names, tids, name_idx, tid_idx, t0s, durs, args,
     thread_names, wall_ns, perf_ns) = _spans._export_columns(since_ns)
    return {
        "v": TRACE_STATE_VERSION,
        "pid": pid,
        "host": socket.gethostname(),
        "worker_id": worker_id,
        "wall_ns": wall_ns,
        "perf_ns": perf_ns,
        "epoch_ns": epoch_ns,
        "clock_offset_ns": int(clock_offset_ns),
        "names": names,
        "name_idx": np.array(name_idx, np.int32),
        "tids": tids,
        "tid_idx": np.array(tid_idx, np.int32),
        "t0_ns": np.array(t0s, np.int64),
        "dur_ns": np.array(durs, np.int64),
        "args_json": _args_json({i: a for i, a in enumerate(args) if a}),
        "thread_names": {int(t): nm for t, nm in thread_names.items()},
    }


def ntp_offset(samples: Sequence[Tuple[int, int, int]]) -> Tuple[int, int]:
    """NTP-style clock offset from ping round-trips.

    ``samples`` holds ``(t0_ns, server_ns, t1_ns)`` per round trip: the
    caller's wall clock at send and receive bracketing the server's wall
    stamp. Assuming symmetric delay, the server's clock leads the caller's by
    ``server_ns - (t0 + t1) / 2``; the MEDIAN across rounds rejects the
    odd delayed exchange. Returns ``(offset_ns, uncertainty_ns)`` where the
    uncertainty is half the best observed RTT — the worst-case error a fully
    asymmetric path could hide inside the tightest round trip."""
    if not samples:
        raise ValueError("ntp_offset needs at least one (t0, server, t1) sample")
    offsets = sorted(s_ns - (t0 + t1) // 2 for t0, s_ns, t1 in samples)
    rtt_min = min(t1 - t0 for t0, _, t1 in samples)
    return offsets[len(offsets) // 2], max(0, rtt_min // 2)


def _wall_starts(state: Dict[str, Any]) -> np.ndarray:
    """Per-span chief-timeline wall-clock starts (ns) for one blob."""
    base = (int(state["wall_ns"]) - int(state["perf_ns"])
            + int(state.get("clock_offset_ns", 0)))
    return np.asarray(state["t0_ns"], np.int64) + base


def _lane_label(state: Dict[str, Any]) -> str:
    wid = state.get("worker_id")
    who = "chief" if wid is None else f"worker {wid}"
    return f"{who} ({state.get('host', '?')} pid {state.get('pid', '?')})"


def trace_state_events(state: Dict[str, Any], pid: int,
                       origin_ns: int) -> List[Dict[str, Any]]:
    """One blob as Chrome trace events on lane ``pid``: an ``M``
    process_name event, ``M`` thread_name events, then one ``X`` (complete)
    event per span with ``ts``/``dur`` in microseconds relative to
    ``origin_ns`` (a chief-timeline wall stamp)."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": _lane_label(state)}}]
    tids = [int(t) for t in state["tids"]]
    thread_names = {int(t): nm
                    for t, nm in dict(state.get("thread_names", {})).items()}
    for tid in sorted(set(tids)):
        nm = thread_names.get(tid)
        if nm:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": nm}})
    names = list(state["names"])
    name_idx = np.asarray(state["name_idx"], np.int64)
    tid_idx = np.asarray(state["tid_idx"], np.int64)
    dur_ns = np.asarray(state["dur_ns"], np.int64)
    starts = _wall_starts(state)
    args_map = _parse_args_json(state)
    for i in range(len(name_idx)):
        events.append({
            "name": names[name_idx[i]],
            "ph": "X",
            "cat": "host",
            "ts": float(int(starts[i]) - origin_ns) / 1e3,
            "dur": float(dur_ns[i]) / 1e3,
            "pid": pid,
            "tid": tids[tid_idx[i]],
            "args": args_map.get(i) or {},
        })
    return events


def _assign_pid(state: Dict[str, Any], used: set) -> int:
    """Deterministic lane id: chief -> 0, worker w -> w + 1, collisions walk
    to the next free id (two blobs from the same worker id stay distinct).
    Non-numeric worker labels (adtrace tags blobs with their ``host:port``
    endpoint) start from the next free slot after the numeric lanes."""
    wid = state.get("worker_id")
    if wid is None:
        pid = 0
    else:
        try:
            pid = int(wid) + 1
        except (TypeError, ValueError):
            pid = len(used) + 1
    while pid in used:
        pid += 1
    used.add(pid)
    return pid


def instant_trace_events(records: Iterable[Dict[str, Any]], pid: int,
                         origin_ns: int) -> List[Dict[str, Any]]:
    """Registry event records (``telemetry.events()`` /
    :func:`load_events_jsonl`) as Chrome INSTANT events on lane ``pid``:
    a process_name metadata event plus one ``"i"`` (global-scope) marker per
    record, placed by its ``t_wall_s`` wall stamp relative to ``origin_ns``
    — so anomalies appear as vertical markers over the span timeline."""
    out: List[Dict[str, Any]] = []
    markers = []
    for rec in records:
        rec = dict(rec)
        name = str(rec.pop("name", "event"))
        t_wall_s = rec.pop("t_wall_s", None)
        if t_wall_s is None:
            continue
        markers.append({
            "name": name, "ph": "i", "s": "g", "cat": "anomaly",
            "ts": (float(t_wall_s) * 1e9 - origin_ns) / 1e3,
            "pid": pid, "tid": 0,
            "args": _sanitize_args(rec) or {},
        })
    if markers:
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": "events (anomalies)"}})
        out.extend(markers)
    return out


def merge_trace_states(states: Iterable[Dict[str, Any]], path: str,
                       instant_events: Iterable[Dict[str, Any]] = (),
                       reqtrace_states: Iterable[Dict[str, Any]] = ()) -> str:
    """Merge trace blobs into ONE Chrome trace file at ``path``.

    Every blob's spans are rebased onto the chief wall clock
    (``wall + clock_offset_ns``); the merged origin is the earliest rebased
    span start across all lanes, so the file opens at t=0 in Perfetto.
    ``instant_events`` (registry event records — anomalies) overlay the
    timeline as instant markers on their own lane. ``reqtrace_states``
    (request-lifecycle blobs, :func:`local_reqtrace_state`) add per-request
    lanes and flow arrows (router ``sent`` -> replica ``received``) on the
    SAME clock; a reqtrace blob from a process that also contributed a span
    blob (matched by host + OS pid) shares that process's lane. Returns
    ``path``."""
    states = list(states)
    reqtrace_states = list(reqtrace_states)
    for st in states:
        v = st.get("v", TRACE_STATE_VERSION)
        if v != TRACE_STATE_VERSION:
            raise ValueError(f"trace state version {v} is not supported "
                             f"(this build reads v{TRACE_STATE_VERSION})")
    for st in reqtrace_states:
        v = st.get("v", REQTRACE_STATE_VERSION)
        if v != REQTRACE_STATE_VERSION:
            raise ValueError(f"reqtrace state version {v} is not supported "
                             f"(this build reads v{REQTRACE_STATE_VERSION})")
    origins = [int(_wall_starts(st).min()) for st in states
               if len(np.asarray(st["t0_ns"])) > 0]
    for st in reqtrace_states:
        marks = reqtrace_marks(st)
        if marks:
            origins.append(min(m["wall_ns"] for m in marks))
    instant_events = list(instant_events)
    if not origins and instant_events:
        # Every ring is empty (recording off — an armed recorder without
        # AUTODIST_TELEMETRY still snapshots): anchor the timeline on the
        # earliest event so markers sit near t=0, not at epoch scale.
        stamps = [float(r["t_wall_s"]) for r in instant_events
                  if r.get("t_wall_s") is not None]
        origins = [int(min(stamps) * 1e9)] if stamps else []
    origin_ns = min(origins) if origins else 0
    events: List[Dict[str, Any]] = []
    used: set = set()
    lane_by_proc: Dict[Tuple[Any, Any], int] = {}
    for st in states:
        pid = _assign_pid(st, used)
        lane_by_proc.setdefault((st.get("host"), st.get("pid")), pid)
        events.extend(trace_state_events(st, pid, origin_ns))
    for st in reqtrace_states:
        key = (st.get("host"), st.get("pid"))
        pid = lane_by_proc.get(key)
        if pid is None:
            pid = lane_by_proc[key] = _assign_pid(st, used)
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": _lane_label(st)}})
        events.extend(reqtrace_trace_events(st, pid, origin_ns))
    if instant_events:
        pid = max(used) + 1 if used else 0
        events.extend(instant_trace_events(instant_events, pid, origin_ns))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    n_spans = sum(1 for ev in events if ev["ph"] == "X")
    logging.info("Wrote cluster trace: %d span(s) across %d lane(s) to %s",
                 n_spans, len(states), path)
    return path


def collect_cluster_trace(path: str, server=None, peers: Iterable = (),
                          since_ns: Optional[int] = None,
                          include_local: bool = True) -> str:
    """Emit ONE clock-aligned Chrome trace for the cluster at ``path``.

    Lanes, in order:

    - this process's own ring (``include_local``, offset 0 — the caller IS
      the timeline's reference clock; on the chief that is exactly right),
    - every blob pulled from ``peers`` — objects with a
      ``trace(since_ns)`` method, e.g. a
      :class:`~autodist_tpu_torch.parallel.ps_transport.RemotePSWorker` pulling
      the chief's ring from a worker process,
    - every blob workers PUSHED to ``server`` (a
      :class:`~autodist_tpu_torch.parallel.ps_transport.PSServer`; workers deposit
      their rings via ``RemotePSWorker.push_trace()``, automatic at close
      under ``AUTODIST_TRACE_PULL=1``), already carrying each pusher's
      estimated chief-clock offset.

    ``AsyncPSRunner.collect_cluster_trace(path)`` is the chief-side
    convenience wrapper that passes its own PSServer. Load the file in
    ui.perfetto.dev next to a ``torch.profiler`` device trace; each worker is
    its own ``pid`` lane."""
    states: List[Dict[str, Any]] = []
    if include_local:
        states.append(local_trace_state(since_ns))
    for peer in peers:
        states.append(peer.trace(since_ns))
    if server is not None:
        for _, st in sorted(server.worker_traces().items(), key=lambda kv:
                            (str(kv[0]))):
            states.append(st)
    return merge_trace_states(states, path)


def dump_spans_jsonl(path: str, worker_id: Optional[int] = None,
                     since_ns: Optional[int] = None,
                     clock_offset_ns: int = 0) -> str:
    """Dump this process's span ring as JSONL for offline merging.

    Line 1 is the blob's metadata (``{"meta": {...}}``); every following
    line is one span ``[name, tid, t0_ns, dur_ns, args]``. The offline
    counterpart of the ``trace``/``push_trace`` wire path — each worker
    dumps its own file, ``tools/tracedump.py`` merges them afterwards."""
    state = local_trace_state(since_ns, worker_id=worker_id,
                              clock_offset_ns=clock_offset_ns)
    meta = {k: state[k] for k in ("v", "pid", "host", "worker_id", "wall_ns",
                                  "perf_ns", "epoch_ns", "clock_offset_ns",
                                  "thread_names")}
    names = state["names"]
    tids = state["tids"]
    args_map = _parse_args_json(state)
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for i in range(len(state["name_idx"])):
            f.write(json.dumps([names[state["name_idx"][i]],
                                tids[state["tid_idx"][i]],
                                int(state["t0_ns"][i]),
                                int(state["dur_ns"][i]),
                                args_map.get(i)]) + "\n")
    return path


def load_trace_jsonl(path: str,
                     clock_offset_ns: Optional[int] = None) -> Dict[str, Any]:
    """Load a :func:`dump_spans_jsonl` file back into a trace blob;
    ``clock_offset_ns`` overrides the dumped offset (the ``tracedump
    --offset`` hook for dumps written before an offset was known)."""
    with open(path) as f:
        header = json.loads(f.readline())
        if not isinstance(header, dict) or "meta" not in header:
            raise ValueError(f"{path}: not a span JSONL dump (no meta line)")
        meta = header["meta"]
        if meta.get("v", TRACE_STATE_VERSION) != TRACE_STATE_VERSION:
            raise ValueError(f"{path}: trace dump version {meta.get('v')} is "
                             f"not supported (this build reads "
                             f"v{TRACE_STATE_VERSION})")
        rows = [json.loads(line) for line in f if line.strip()]
    names: List[str] = []
    name_ix: Dict[str, int] = {}
    tids: List[int] = []
    tid_ix: Dict[int, int] = {}
    n = len(rows)
    name_idx = np.empty(n, np.int32)
    tid_idx = np.empty(n, np.int32)
    t0_ns = np.empty(n, np.int64)
    dur_ns = np.empty(n, np.int64)
    args_map: Dict[int, Dict[str, Any]] = {}
    for i, (name, tid, t0, dur, args) in enumerate(rows):
        j = name_ix.get(name)
        if j is None:
            j = name_ix[name] = len(names)
            names.append(name)
        name_idx[i] = j
        k = tid_ix.get(tid)
        if k is None:
            k = tid_ix[tid] = len(tids)
            tids.append(int(tid))
        tid_idx[i] = k
        t0_ns[i] = t0
        dur_ns[i] = dur
        if args:
            args_map[i] = args
    state = dict(meta)
    if clock_offset_ns is not None:
        state["clock_offset_ns"] = int(clock_offset_ns)
    state.update(names=names, name_idx=name_idx, tids=tids, tid_idx=tid_idx,
                 t0_ns=t0_ns, dur_ns=dur_ns,
                 args_json=_args_json(args_map))
    state["thread_names"] = {int(t): nm for t, nm in
                             dict(meta.get("thread_names", {})).items()}
    return state


# --------------------------------------------------------- request traces

# Named sub-intervals a request's marks imply, rendered as "X" slices on the
# request's lane: (slice name, start phase, end phase). First occurrence of
# the start phase, last of the end phase — a replayed request's repeated
# marks widen the interval instead of fragmenting it.
_REQ_INTERVALS = (
    ("queue", "queued", "admitted"),
    ("prefill", "prefill_start", "prefill_end"),
    ("decode", "first_token", "done"),
    ("route", "received", "finished"),
)
# Phases rendered as instant markers (discrete lifecycle facts, no duration).
_REQ_INSTANTS = ("shed", "replayed")
# Request lanes use tids far above any interned-span lane index but well
# below real pthread idents, so a merged file never collides either way.
_REQ_TID_BASE = 1_000_000


def local_reqtrace_state(since_ns: Optional[int] = None,
                         worker_id: Optional[int] = None,
                         clock_offset_ns: int = 0) -> Dict[str, Any]:
    """Snapshot this process's request-lifecycle ring
    (:mod:`autodist_tpu_torch.telemetry.reqtrace`) as a wire-encodable columnar
    blob — the ``reqtrace`` opcode's payload, same shape discipline as
    :func:`local_trace_state`: a de-duplicated phase table, an int32 phase
    index column, int64 mark stamps, rids verbatim (they are the join key
    and unbounded — interning them would leak), sparse mark args as one
    JSON string, and the back-to-back ``(wall_ns, perf_ns)`` pair the merge
    rebases with."""
    (pid, epoch_ns, phases, rids, phase_idx, t_ns, args,
     wall_ns, perf_ns) = _reqtrace._export_columns(since_ns)
    return {
        "v": REQTRACE_STATE_VERSION,
        "pid": pid,
        "host": socket.gethostname(),
        "worker_id": worker_id,
        "wall_ns": wall_ns,
        "perf_ns": perf_ns,
        "epoch_ns": epoch_ns,
        "clock_offset_ns": int(clock_offset_ns),
        "phases": phases,
        "rids": [str(r) for r in rids],
        "phase_idx": np.array(phase_idx, np.int32),
        "t_ns": np.array(t_ns, np.int64),
        "args_json": _args_json({i: _sanitize_args(a)
                                 for i, a in enumerate(args) if a}),
    }


def reqtrace_marks(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One blob's marks rebased onto the merged timeline's wall clock:
    ``{rid, phase, wall_ns, args}`` dicts, oldest first. ``wall_ns`` is the
    blob's wall/perf pair applied to the mark stamp plus the blob's
    ``clock_offset_ns`` — the exact :func:`_wall_starts` arithmetic, so
    span slices and request marks from one process land on one clock."""
    base = (int(state["wall_ns"]) - int(state["perf_ns"])
            + int(state.get("clock_offset_ns", 0)))
    phases = list(state["phases"])
    args_map = _parse_args_json(state)
    out: List[Dict[str, Any]] = []
    rids = list(state["rids"])
    phase_idx = np.asarray(state["phase_idx"], np.int64)
    t_ns = np.asarray(state["t_ns"], np.int64)
    for i in range(len(rids)):
        out.append({"rid": rids[i], "phase": phases[phase_idx[i]],
                    "wall_ns": int(t_ns[i]) + base,
                    "args": args_map.get(i) or {}})
    return out


def reqtrace_trace_events(state: Dict[str, Any], pid: int,
                          origin_ns: int) -> List[Dict[str, Any]]:
    """One reqtrace blob as Chrome trace events on lane ``pid``: each rid
    gets its own request lane (tid), its marks become "X" slices for the
    :data:`_REQ_INTERVALS` its phases bound (a ``received`` mark carrying a
    ``wire_ns`` arg additionally yields a ``wire`` slice ENDING at the
    receive — the wire time the trace-context token decomposed), instant
    markers for shed/replay, plus the FLOW halves: a ``"s"`` (flow start)
    at every ``sent`` mark and a ``"f"`` (flow end) at every ``received``
    mark, id ``<rid>/<hop>`` — the merge pairs a router's send arrow with
    the replica's receive across lanes."""
    by_rid = _reqtrace.group_records(reqtrace_marks(state))
    events: List[Dict[str, Any]] = []
    for lane, rid in enumerate(sorted(by_rid, key=str)):
        tid = _REQ_TID_BASE + lane
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"req {rid}"}})
        recs = by_rid[rid]
        first = {}
        last = {}
        for phase, t, args in recs:
            first.setdefault(phase, (t, args))
            last[phase] = (t, args)
        for name, p0, p1 in _REQ_INTERVALS:
            if p0 in first and p1 in last:
                t0, t1 = first[p0][0], last[p1][0]
                if t1 >= t0:
                    events.append({
                        "name": name, "ph": "X", "cat": "reqtrace",
                        "ts": float(t0 - origin_ns) / 1e3,
                        "dur": float(t1 - t0) / 1e3,
                        "pid": pid, "tid": tid, "args": {"rid": str(rid)}})
        for phase, t, args in recs:
            if phase == "received" and args.get("wire_ns"):
                wire_ns = max(0, int(args["wire_ns"]))
                events.append({
                    "name": "wire", "ph": "X", "cat": "reqtrace",
                    "ts": float(t - wire_ns - origin_ns) / 1e3,
                    "dur": float(wire_ns) / 1e3,
                    "pid": pid, "tid": tid, "args": {"rid": str(rid)}})
                events.append({
                    "name": "req", "ph": "f", "bp": "e", "cat": "reqtrace",
                    "id": f"{rid}/{args.get('hop', 0)}",
                    "ts": float(t - origin_ns) / 1e3,
                    "pid": pid, "tid": tid})
            elif phase == "sent":
                events.append({
                    "name": "req", "ph": "s", "cat": "reqtrace",
                    "id": f"{rid}/{args.get('hop', 0)}",
                    "ts": float(t - origin_ns) / 1e3,
                    "pid": pid, "tid": tid})
            elif phase in _REQ_INSTANTS:
                events.append({
                    "name": phase, "ph": "i", "s": "t", "cat": "reqtrace",
                    "ts": float(t - origin_ns) / 1e3,
                    "pid": pid, "tid": tid,
                    "args": dict(_sanitize_args(args) or {}, rid=str(rid))})
    return events


def dump_reqtrace_jsonl(path: str, worker_id: Optional[int] = None,
                        since_ns: Optional[int] = None,
                        clock_offset_ns: int = 0) -> str:
    """Dump this process's request-lifecycle ring as JSONL for offline
    merging (the reqtrace twin of :func:`dump_spans_jsonl`): line 1 is the
    blob metadata (``{"meta": {...}}``), every following line one mark
    ``[rid, phase, t_ns, args]``."""
    state = local_reqtrace_state(since_ns, worker_id=worker_id,
                                 clock_offset_ns=clock_offset_ns)
    meta = {k: state[k] for k in ("v", "pid", "host", "worker_id", "wall_ns",
                                  "perf_ns", "epoch_ns", "clock_offset_ns")}
    meta["kind"] = "reqtrace"
    phases = state["phases"]
    args_map = _parse_args_json(state)
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for i in range(len(state["phase_idx"])):
            f.write(json.dumps([state["rids"][i],
                                phases[state["phase_idx"][i]],
                                int(state["t_ns"][i]),
                                args_map.get(i)]) + "\n")
    return path


def load_reqtrace_jsonl(path: str,
                        clock_offset_ns: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Load a :func:`dump_reqtrace_jsonl` file back into a reqtrace blob;
    ``clock_offset_ns`` overrides the dumped offset (the ``tracedump
    --offset`` hook)."""
    with open(path) as f:
        header = json.loads(f.readline())
        if not isinstance(header, dict) or "meta" not in header \
                or header["meta"].get("kind") != "reqtrace":
            raise ValueError(f"{path}: not a reqtrace JSONL dump")
        meta = dict(header["meta"])
        if meta.get("v", REQTRACE_STATE_VERSION) != REQTRACE_STATE_VERSION:
            raise ValueError(f"{path}: reqtrace dump version {meta.get('v')} "
                             f"is not supported (this build reads "
                             f"v{REQTRACE_STATE_VERSION})")
        rows = [json.loads(line) for line in f if line.strip()]
    meta.pop("kind", None)
    phases: List[str] = []
    phase_ix: Dict[str, int] = {}
    n = len(rows)
    phase_idx = np.empty(n, np.int32)
    t_ns = np.empty(n, np.int64)
    rids: List[str] = []
    args_map: Dict[int, Dict[str, Any]] = {}
    for i, (rid, phase, t, args) in enumerate(rows):
        j = phase_ix.get(phase)
        if j is None:
            j = phase_ix[phase] = len(phases)
            phases.append(phase)
        phase_idx[i] = j
        t_ns[i] = t
        rids.append(str(rid))
        if args:
            args_map[i] = args
    state = meta
    if clock_offset_ns is not None:
        state["clock_offset_ns"] = int(clock_offset_ns)
    state.update(phases=phases, rids=rids, phase_idx=phase_idx, t_ns=t_ns,
                 args_json=_args_json(args_map))
    return state


def dump_events_jsonl(path: str, events=None) -> str:
    """Dump structured registry events (``telemetry.events()``) as JSONL —
    one record per line — so anomaly records survive process exit. The event
    ring is in-process and drain-only otherwise; this is its offline leg
    (the flight recorder writes one per snapshot, ``tools/tracedump.py
    --events`` merges the file back into a timeline as instant markers).
    ``events`` defaults to the process registry's current ring."""
    from autodist_tpu_torch.telemetry import metrics as _metrics
    if events is None:
        events = _metrics.events()
    with open(path, "w") as f:
        for rec in events:
            f.write(json.dumps(rec, default=str) + "\n")
    return path


def load_events_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a :func:`dump_events_jsonl` file back into event records,
    oldest first (each line must be one JSON object with at least a
    ``name``)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            rec = json.loads(line)
            if not isinstance(rec, dict) or "name" not in rec:
                raise ValueError(f"{path}:{i + 1}: not an event record "
                                 f"(expected a JSON object with 'name')")
            out.append(rec)
    return out
