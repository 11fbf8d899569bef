"""tracedump — merge per-worker host-span JSONL dumps into one Chrome trace.

The offline half of the cluster trace plane
(``autodist_tpu_torch/telemetry/cluster.py``): when no PS transport was up to
``push_trace`` through — single-process debugging, a run that crashed before
collection, or logs copied off a pod — each worker's
``telemetry.dump_spans_jsonl(path, worker_id=..)`` file can still be merged
after the fact into the same clock-aligned, pid-lane-per-worker timeline
``telemetry.collect_cluster_trace`` produces online.

Usage:
    python -m autodist_tpu_torch.tools.tracedump out.json w0.jsonl w1.jsonl [w2.jsonl ...]
    python -m autodist_tpu_torch.tools.tracedump out.json *.jsonl --offset 1:250000 --offset 2:-80000
    python -m autodist_tpu_torch.tools.tracedump out.json *.jsonl --events flightrec/snap-0000-*/events.jsonl

``--offset WID:NS`` overrides a dump's recorded chief-clock offset
(nanoseconds to ADD to that worker's wall clock) — for dumps written before
any offset was estimated. ``--events FILE`` (repeatable) merges structured
registry-event dumps (``telemetry.dump_events_jsonl`` files — the flight
recorder writes one per snapshot) into the timeline as INSTANT markers on
their own lane, so anomalies line up against the spans that surround them.
``--reqtrace FILE`` (repeatable) merges request-lifecycle dumps
(``telemetry.dump_reqtrace_jsonl`` files — the request-trace plane's
offline exit) as per-request lanes with router->replica flow arrows, so a
post-mortem gets the same flow-linked timeline ``adtrace --out``
pulls live. Load the output in ui.perfetto.dev or chrome://tracing.
"""

import argparse
import sys


def _parse_offset(spec: str):
    try:
        wid, ns = spec.split(":", 1)
        return int(wid), int(ns)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--offset wants WID:NANOSECONDS, got {spec!r}")


def merge_dumps(out_path: str, inputs, offsets=None, event_files=(),
                reqtrace_files=()) -> str:
    """Merge span JSONL dumps at ``inputs`` into one Chrome trace at
    ``out_path``; ``offsets`` maps worker id -> clock_offset_ns override,
    ``event_files`` are registry-event JSONL dumps overlaid as instant
    markers, and ``reqtrace_files`` are request-lifecycle JSONL dumps merged
    as per-request flow-linked lanes. Returns ``out_path`` (the test-facing
    entry point — main() is argv plumbing around it)."""
    from autodist_tpu_torch.telemetry import cluster
    offsets = offsets or {}
    states = []
    for path in inputs:
        state = cluster.load_trace_jsonl(path)
        wid = state.get("worker_id")
        if wid in offsets:
            state["clock_offset_ns"] = offsets[wid]
        states.append(state)
    events = []
    for path in event_files:
        events.extend(cluster.load_events_jsonl(path))
    req_states = []
    for path in reqtrace_files:
        state = cluster.load_reqtrace_jsonl(path)
        wid = state.get("worker_id")
        if wid in offsets:
            state["clock_offset_ns"] = offsets[wid]
        req_states.append(state)
    return cluster.merge_trace_states(states, out_path,
                                      instant_events=events,
                                      reqtrace_states=req_states)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracedump", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", help="output Chrome trace JSON path")
    ap.add_argument("inputs", nargs="+",
                    help="per-worker span JSONL dumps "
                         "(telemetry.dump_spans_jsonl files)")
    ap.add_argument("--offset", action="append", type=_parse_offset,
                    default=[], metavar="WID:NS",
                    help="override worker WID's chief-clock offset "
                         "(ns to add; repeatable)")
    ap.add_argument("--events", action="append", default=[], metavar="FILE",
                    help="registry-event JSONL dump "
                         "(telemetry.dump_events_jsonl file) to overlay as "
                         "instant markers (repeatable)")
    ap.add_argument("--reqtrace", action="append", default=[],
                    metavar="FILE",
                    help="request-lifecycle JSONL dump "
                         "(telemetry.dump_reqtrace_jsonl file) to merge as "
                         "flow-linked per-request lanes (repeatable)")
    args = ap.parse_args(argv)
    try:
        merge_dumps(args.out, args.inputs, offsets=dict(args.offset),
                    event_files=args.events, reqtrace_files=args.reqtrace)
    except (OSError, ValueError) as e:
        print(f"tracedump: {e}", file=sys.stderr)
        return 1
    print(f"tracedump: wrote {args.out} ({len(args.inputs)} lane(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
