"""adtrace — request-scoped tracing console for a serving fleet.

The rendering half of the request-trace plane
(``autodist_tpu_torch/telemetry/reqtrace.py``): every serving process records
request lifecycle marks (received / queued / admitted / prefill / decode /
shed / replayed / finished) keyed by the ROUTER-SCOPE rid when
``AUTODIST_REQTRACE=1`` is armed. adtrace pulls those rings fleet-wide via
the ``reqtrace`` wire opcode, rebases every process onto ONE clock
(``ping``-based ntp offsets, the cluster trace plane's estimator), joins
the marks by rid, and answers "why was this p99 request slow":

- a per-phase breakdown table — wire / queue / admit-wait / prefill /
  decode / total with n, p50, p99, max across every completed request;
- top-K slowest-request WATERFALLS — one request's marks as a relative
  timeline, naming the replica each hop landed on (a replayed request
  shows its failover inline, same rid, bumped hop);
- ``--out trace.json`` — the merged flow-linked Chrome trace (router lane
  -> replica lane arrows, one sub-lane per request) for ui.perfetto.dev,
  with each process's span ring pulled alongside via the ``trace`` opcode.

A router endpoint is expanded automatically: its ``status`` reply carries
the replica fleet table, so pointing adtrace at the front door traces the
whole fleet. Offline, ``--jsonl`` merges ``telemetry.dump_reqtrace_jsonl``
files instead (no transport up — post-mortem).

Usage:
    python -m autodist_tpu_torch.tools.adtrace ROUTER_HOST:PORT             # tables + waterfalls
    python -m autodist_tpu_torch.tools.adtrace A:1 B:2 --top 5 --out t.json
    python -m autodist_tpu_torch.tools.adtrace --jsonl r0.jsonl r1.jsonl
"""

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

# Interval phases priced in the breakdown table: (row, start mark, end mark).
# ``wire`` is special-cased (it is an ARG on the replica's received mark, not
# a mark pair — the trace token decomposed it from queue time on arrival).
PHASE_ROWS = (("queue", "queued", "admitted"),
              ("prefill", "prefill_start", "prefill_end"),
              ("decode", "first_token", "done"),
              ("total", "received", "finished"))


def _endpoint_offset_ns(client, rounds: int = 3) -> int:
    """Tool-clock-minus-endpoint clock offset via ntp over ``ping``
    round-trips — the sign :func:`cluster.merge_trace_states` rebasing
    expects (offset ADDED to the blob's wall clock lands on ours)."""
    from autodist_tpu_torch.telemetry import cluster
    samples = []
    for _ in range(rounds):
        t0 = time.time_ns()
        _, s_ns = client.call("ping", t0)
        samples.append((t0, int(s_ns), time.time_ns()))
    off, _err = cluster.ntp_offset(samples)   # endpoint minus tool
    return -int(off)


def discover(addresses, timeout: float = 2.0) -> List[str]:
    """Expand the address list through router fleet tables: any endpoint
    whose ``status`` reply is ``kind="router"`` contributes its replicas'
    ``host:port`` names. Unreachable endpoints stay in the list — collect()
    reports them as errors rather than silently shrinking the fleet."""
    from autodist_tpu_torch.parallel.ps_transport import _PSClient
    out, seen = [], set()
    for addr in addresses:
        if addr in seen:
            continue
        seen.add(addr)
        out.append(addr)
        client = _PSClient(_parse_addr(addr), connect_timeout=timeout,
                           read_timeout=timeout)
        try:
            st = client.call("status")[0]
        except Exception:
            continue
        finally:
            client.close()
        if isinstance(st, dict) and st.get("kind") == "router":
            for row in st.get("replicas") or []:
                name = row.get("replica")
                if name and name not in seen:
                    seen.add(name)
                    out.append(name)
    return out


def collect(addresses, timeout: float = 2.0,
            with_spans: bool = False) -> Dict[str, object]:
    """Pull every endpoint's reqtrace ring (and span ring when
    ``with_spans``) onto the tool's clock. Returns ``{"states": [...],
    "span_states": [...], "errors": {addr: msg}}``; each blob's
    ``worker_id`` is set to its endpoint string so merged lanes read as
    addresses, and its ``clock_offset_ns`` to the ping-estimated
    tool-minus-endpoint offset."""
    from autodist_tpu_torch.parallel.ps_transport import _PSClient
    states, span_states, errors = [], [], {}
    for addr in addresses:
        client = _PSClient(_parse_addr(addr), connect_timeout=timeout,
                           read_timeout=timeout)
        try:
            off = _endpoint_offset_ns(client)
            st = client.call("reqtrace")[0]
            st["worker_id"] = addr
            st["clock_offset_ns"] = off
            states.append(st)
            if with_spans:
                sp = client.call("trace")[0]
                sp["worker_id"] = addr
                sp["clock_offset_ns"] = off
                span_states.append(sp)
        except Exception as e:
            errors[addr] = f"{type(e).__name__}: {e}"
        finally:
            client.close()
    return {"states": states, "span_states": span_states, "errors": errors}


def dedupe_states(states) -> List[dict]:
    """One blob per OS process. The rings are process-global, so an
    in-process fleet (the tests' loopback topology — router and replicas in
    one interpreter) returns the SAME ring from every endpoint; keeping one
    blob per ``(host, pid)`` (the fullest, pulls race the ring) stops the
    merged report triple-counting every mark. Distinct processes always
    differ in OS pid and are never collapsed."""
    best: Dict[Tuple[object, object], dict] = {}
    order: List[Tuple[object, object]] = []

    def _n(st):
        return len(st.get("rids", st.get("t0_ns", ())))

    for st in states:
        key = (st.get("host"), st.get("pid"))
        cur = best.get(key)
        if cur is None:
            best[key] = st
            order.append(key)
        elif _n(st) > _n(cur):
            best[key] = st
    return [best[k] for k in order]


def merged_marks(states) -> List[dict]:
    """Every blob's marks rebased onto one clock, tagged with their source
    endpoint (``src``), time-sorted — the row-wise form the tables and
    waterfalls consume."""
    from autodist_tpu_torch.telemetry import cluster
    marks: List[dict] = []
    for st in dedupe_states(states):
        src = st.get("worker_id")
        src = str(src) if src is not None else f"pid {st.get('pid', '?')}"
        for m in cluster.reqtrace_marks(st):
            m["src"] = src
            marks.append(m)
    marks.sort(key=lambda m: (int(m["wall_ns"]), str(m["rid"])))
    return marks


def phase_durations(marks) -> Dict[str, List[Tuple[float, object]]]:
    """Per-phase ``(seconds, rid)`` samples across requests: the
    :data:`PHASE_ROWS` intervals (first start to last end per rid — a
    replayed request prices its WHOLE story, failover included), ``wire``
    from the received marks' decomposed ``wire_ns`` args, ``admit_wait``
    from the gap between an admit_wait mark and the admission."""
    from autodist_tpu_torch.telemetry import reqtrace
    out: Dict[str, List[Tuple[float, object]]] = {}
    for rid, recs in reqtrace.group_records(marks).items():
        first, last = {}, {}
        for phase, t, args in recs:
            first.setdefault(phase, (t, args))
            last[phase] = (t, args)
        for row, p0, p1 in PHASE_ROWS:
            if p0 in first and p1 in last:
                dt = (last[p1][0] - first[p0][0]) / 1e9
                if dt >= 0:
                    out.setdefault(row, []).append((dt, rid))
        for phase, t, args in recs:
            if phase == "received" and args.get("wire_ns") is not None:
                out.setdefault("wire", []).append(
                    (int(args["wire_ns"]) / 1e9, rid))
        if "admit_wait" in first and "admitted" in last:
            dt = (last["admitted"][0] - first["admit_wait"][0]) / 1e9
            if dt >= 0:
                out.setdefault("admit_wait", []).append((dt, rid))
    return out


def _pct(samples: List[float], q: float) -> float:
    xs = sorted(samples)
    if not xs:
        return 0.0
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def _ms(s: float) -> str:
    return f"{s * 1e3:9.2f}ms"


def render_table(durations) -> str:
    """The per-phase breakdown: n / p50 / p99 / max, phases in pipeline
    order: where the fleet's request time actually goes."""
    order = ("wire", "queue", "admit_wait", "prefill", "decode", "total")
    lines = [f"  {'phase':<11} {'n':>6} {'p50':>11} {'p99':>11} {'max':>11}"]
    for row in order:
        samp = durations.get(row)
        if not samp:
            continue
        xs = [s for s, _ in samp]
        lines.append(f"  {row:<11} {len(xs):>6} {_ms(_pct(xs, 0.5))} "
                     f"{_ms(_pct(xs, 0.99))} {_ms(max(xs))}")
    if len(lines) == 1:
        return "  (no completed requests recorded — is AUTODIST_REQTRACE=1 " \
               "armed on the fleet?)"
    return "\n".join(lines)


def render_waterfall(rid, recs) -> List[str]:
    """One request's marks as a relative timeline: +offset, phase, source
    endpoint, and the arg payload that names the story (replica routed to,
    hop, wire decomposition, shed reason)."""
    t0 = recs[0][1] if recs else 0
    lines = []
    for phase, t, args in recs:
        extra = ""
        if args:
            parts = []
            for k in ("replica", "hop", "slot", "reason", "depth", "tokens",
                      "prompt_len", "pages_needed", "pages_free"):
                if k in args:
                    parts.append(f"{k}={args[k]}")
            if "wire_ns" in args:
                parts.append(f"wire={int(args['wire_ns']) / 1e6:.2f}ms")
            extra = "  " + " ".join(parts) if parts else ""
        src = args.get("src", "") if args else ""
        lines.append(f"    +{(t - t0) / 1e6:9.2f}ms  {phase:<13}"
                     f"{(' @' + src) if src else '':<24}{extra}")
    return lines


def render_report(states, top: int = 3) -> str:
    """The whole plain-text report for a set of reqtrace blobs: breakdown
    table, then the top-K slowest completed requests as waterfalls. One
    rendering path for live pulls, offline JSONL merges, and tests."""
    from autodist_tpu_torch.telemetry import reqtrace
    marks = merged_marks(states)
    for m in marks:   # thread the source into the args the waterfall prints
        m["args"] = dict(m.get("args") or {}, src=m["src"])
    durations = phase_durations(marks)
    lines = [f"adtrace — {len(states)} process(es), "
             f"{len(marks)} mark(s), "
             f"{len(durations.get('total', []))} completed request(s)"]
    lines.append(render_table(durations))
    slowest = sorted(durations.get("total", []), reverse=True,
                     key=lambda sr: sr[0])[:max(0, top)]
    if slowest:
        grouped = reqtrace.group_records(marks)
        lines.append(f"  slowest {len(slowest)} request(s):")
        for total_s, rid in slowest:
            lines.append(f"  rid {rid}  total {total_s * 1e3:.2f}ms")
            lines.extend(render_waterfall(rid, grouped.get(rid, [])))
    return "\n".join(lines)


def write_chrome_trace(out_path: str, states, span_states=()) -> str:
    """The merged flow-linked Chrome trace: span lanes (when pulled) plus
    per-request reqtrace lanes and router->replica flow arrows, one clock."""
    from autodist_tpu_torch.telemetry import cluster
    return cluster.merge_trace_states(dedupe_states(span_states), out_path,
                                      reqtrace_states=dedupe_states(states))


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, sep, port = addr.rpartition(":")
    if not sep:
        raise ValueError(f"endpoint {addr!r} is not HOST:PORT")
    return host, int(port)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="adtrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("addresses", nargs="*", default=[],
                    help="serving endpoints host:port (a router endpoint "
                         "expands to its replica fleet; default: "
                         "AUTODIST_ROUTER_ADDR / AUTODIST_SERVE_ADDR)")
    ap.add_argument("--jsonl", action="append", default=[], metavar="FILE",
                    help="offline reqtrace JSONL dump "
                         "(telemetry.dump_reqtrace_jsonl file; repeatable — "
                         "replaces the live pull)")
    ap.add_argument("--top", type=int, default=3,
                    help="slowest-request waterfalls to print (default 3)")
    ap.add_argument("--out", default="",
                    help="also write the merged flow-linked Chrome trace "
                         "JSON here (pulls span rings alongside)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint connect/read deadline seconds")
    args = ap.parse_args(argv)
    if args.jsonl:
        from autodist_tpu_torch.telemetry import cluster
        try:
            states = [cluster.load_reqtrace_jsonl(p) for p in args.jsonl]
        except (OSError, ValueError) as e:
            print(f"adtrace: {e}", file=sys.stderr)
            return 1
        errors = {}
        span_states = []
    else:
        addresses = list(args.addresses)
        if not addresses:
            from autodist_tpu_torch import const
            addresses = [a for a in (str(const.ENV.AUTODIST_ROUTER_ADDR.val),
                                     str(const.ENV.AUTODIST_SERVE_ADDR.val))
                         if a]
        if not addresses:
            print("adtrace: no endpoints given and neither "
                  "AUTODIST_ROUTER_ADDR nor AUTODIST_SERVE_ADDR is set",
                  file=sys.stderr)
            return 2
        addresses = discover(addresses, timeout=args.timeout)
        got = collect(addresses, timeout=args.timeout,
                      with_spans=bool(args.out))
        states, span_states = got["states"], got["span_states"]
        errors = got["errors"]
    print(render_report(states, top=args.top))
    for addr, msg in sorted(errors.items()):
        print(f"adtrace: {addr} unreachable ({msg})", file=sys.stderr)
    if args.out:
        write_chrome_trace(args.out, states, span_states)
        print(f"adtrace: wrote {args.out} ({len(states)} reqtrace + "
              f"{len(span_states)} span lane(s))")
    if not states:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
