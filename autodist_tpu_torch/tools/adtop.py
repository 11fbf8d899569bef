"""adtop — a top-style live console for autodist servers.

Polls any PSServer or InferenceServer address over the ``status`` wire opcode
and renders one screen: uptime and throughput counters, a per-worker table
(last-seen age, instantaneous staleness lag, gate-entry lag histogram, wire
traffic) for training endpoints, the queue/batch/in-flight-request table for
serving endpoints, the attribution plane's ``train.mfu``/``train.membw_util``
and ``train.attr.*`` phase-share gauges when profiling is on, the
``train.health.*`` gauges when the health monitors are on, and the most
recent anomaly events (watchdog stalls/stragglers, health NaN/spike
records).

Usage:
    python -m autodist_tpu_torch.tools.adtop HOST:PORT                # live screen, 2s refresh
    python -m autodist_tpu_torch.tools.adtop HOST:PORT --interval 5
    python -m autodist_tpu_torch.tools.adtop HOST:PORT --once         # one plain-text snapshot
    python -m autodist_tpu_torch.tools.adtop HOST:PORT --raw          # one raw JSON snapshot

With no address, ``AUTODIST_PS_ADDR`` then ``AUTODIST_SERVE_ADDR`` is tried.
``--once``/``--raw`` are what headless boxes, scripts, and the tests use; the
live screen needs only ANSI clear-home (no curses dependency), so it works in
any terminal the training job's logs already scroll through.
"""

import argparse
import json
import sys
import time


def fetch_status(address, timeout: float = 10.0) -> dict:
    """One ``status`` request against ``address`` (``host:port`` or a
    ``(host, port)`` tuple); raises ConnectionError/PSClientError on an
    unreachable or pre-``status`` server. ``timeout`` bounds the reply wait
    too — a hung-but-accepting server must error a console poll, not park
    it forever."""
    from autodist_tpu_torch.parallel.ps_transport import _PSClient
    client = _PSClient(address, connect_timeout=timeout,
                       read_timeout=timeout)
    try:
        return client.call("status")[0]
    finally:
        client.close()


def _fmt_age(seconds) -> str:
    seconds = float(seconds)
    if seconds < 120:
        return f"{seconds:.1f}s"
    if seconds < 7200:
        return f"{seconds / 60:.1f}m"
    return f"{seconds / 3600:.1f}h"


def _hist_quantile(hist: dict, q: float):
    """The SHARED bucket-interpolating estimator
    (:func:`autodist_tpu_torch.telemetry.metrics.quantile`) — the alert engine's
    burn-rate predicate and adfleet's aggregation use the same one, so no
    two consoles can disagree on what p99 means."""
    from autodist_tpu_torch.telemetry import metrics as _metrics
    return _metrics.quantile(hist, q)


def _counter(reg: dict, name: str):
    v = reg.get(name)
    return v if isinstance(v, (int, float)) else None


def _perf_lines(reg: dict) -> list:
    """The attribution plane's roofline + phase-share gauges, one line:
    ``perf     mfu 28.3%  membw 41.2%  attr comp .61 comm .05 host .22
    data .07 rb .05`` (only the gauges the run booked; the share rendering
    is profiling.format_shares — the same one the train: log line uses)."""
    from autodist_tpu_torch.telemetry import profiling
    head = []
    mfu = reg.get("train.mfu")
    if isinstance(mfu, (int, float)):
        head.append(f"mfu {100.0 * mfu:.1f}%")
    bw = reg.get("train.membw_util")
    if isinstance(bw, (int, float)):
        head.append(f"membw {100.0 * bw:.1f}%")
    shares = {phase: reg.get(f"train.attr.{phase}")
              for phase in profiling.ATTR_PHASES
              if isinstance(reg.get(f"train.attr.{phase}"), (int, float))}
    if shares:
        head.append("attr " + profiling.format_shares(shares))
    return ["perf     " + "  ".join(head)] if head else []


def _req_lines(reg: dict, alerts: dict) -> list:
    """The serving request-attribution line: per-scheduler-round
    wire/queue/prefill/decode shares (``serve.attr.*`` — the serving mirror
    of ``train.attr.*``, same sum-to-1.0 contract), plus the exemplar rid
    when a firing alert carries one — the alert names a concrete request and
    this line says where to look (``adtrace`` renders it)."""
    phases = ("wire", "queue", "prefill", "decode")
    shares = {p: reg.get(f"serve.attr.{p}") for p in phases
              if isinstance(reg.get(f"serve.attr.{p}"), (int, float))}
    if not shares:
        return []
    line = "req      attr " + " ".join(
        f"{p} {shares[p]:.2f}".replace(" 0.", " .")
        for p in phases if p in shares)
    for a in (alerts.get("active") or []):
        ex = a.get("exemplar")
        if isinstance(ex, dict) and ex.get("rid") is not None:
            line += f"  exemplar {ex['rid']} ({a.get('rule', '?')})"
            break
    return [line]


def _health_lines(reg: dict) -> list:
    rows = [(k.split("train.health.", 1)[1], v) for k, v in sorted(reg.items())
            if k.startswith("train.health.") and isinstance(v, (int, float))]
    if not rows:
        return []
    return ["health   " + "  ".join(f"{name} {value:.4g}"
                                    for name, value in rows)]


def _event_lines(events, limit: int = 5) -> list:
    out = []
    for rec in list(events)[-limit:]:
        rec = dict(rec)
        name = rec.pop("name", "event")
        t_wall = rec.pop("t_wall_s", None)
        when = time.strftime("%H:%M:%S", time.localtime(t_wall)) \
            if t_wall else "--:--:--"
        fields = " ".join(f"{k}={v}" for k, v in sorted(rec.items()))
        out.append(f"  {when}  {name}  {fields}")
    return out


def _alert_detail(a: dict) -> str:
    """The numbers that tripped one active-alert record, as ``k=v`` pairs —
    ONE formatter shared with ``adfleet`` (like the quantile
    helper: two consoles must read an alert record identically)."""
    return " ".join(f"{k}={v}" for k, v in sorted(a.items())
                    if k not in ("rule", "fired_t_wall_s", "for_s"))


def _alert_line(a: dict, where: str = "") -> str:
    """One active alert as one console line (``where`` splices a fleet
    endpoint in) — the layout itself is shared, not just the detail."""
    return (f"  {a.get('rule', '?'):<18} firing "
            f"{_fmt_age(a.get('for_s', 0))}{where}  {_alert_detail(a)}")


def _alert_lines(alerts: dict) -> list:
    """The status payload's ``alerts`` section: one line per ACTIVE firing
    (rule, how long, the numbers that tripped it), plus a recently-resolved
    count. Nothing when the alert plane never armed (rules == 0)."""
    active = alerts.get("active") or []
    resolved = alerts.get("resolved") or []
    if not active and not resolved:
        return []
    out = [f"alerts   {len(active)} active, {len(resolved)} recently "
           f"resolved (action {alerts.get('action') or '?'})"]
    for a in active:
        out.append(_alert_line(a))
    return out


def _recovery_lines(status: dict) -> list:
    """The status payload's ``recovery`` section: one summary line of action
    counts (evictions/rejoins/rollbacks/respawns) plus the newest record per
    non-empty category. Nothing when the runtime never acted — the healthy
    screen stays unchanged."""
    rec = status.get("recovery") or {}
    counts = rec.get("counts") or {}
    if not any(counts.values()):
        return []
    head = "  ".join(f"{name} {counts[name]}"
                     for name in ("evicted", "rejoined", "rollbacks",
                                  "respawns") if counts.get(name))
    gens = rec.get("generations") or {}
    if gens:
        head += "  gen " + ",".join(f"w{w}:{g}" for w, g in gens.items())
    out = [f"recover  {head}"]
    for label, key in (("evicted", "evictions"), ("rejoined", "rejoins"),
                       ("rollback", "rollbacks"), ("respawn", "respawns")):
        records = rec.get(key) or []
        if records:
            last = dict(records[-1])
            last.pop("t_wall_s", None)
            fields = " ".join(f"{k}={v}" for k, v in sorted(last.items()))
            out.append(f"  last {label}: {fields}")
    return out


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _memory_lines(status: dict) -> list:
    """The status payload's ``memory`` section (the memory plane's census):
    live bytes + pressure against the booked budget, then one owner=bytes
    pair per non-zero census owner (``other`` is the unclaimed residual —
    the leak-hunting number). Nothing while the plane never armed — the
    healthy screen stays unchanged."""
    mem = status.get("memory") or {}
    owned = mem.get("owned") or {}
    if not owned and not mem.get("live_bytes"):
        return []
    head = (f"mem      live {_fmt_bytes(mem.get('live_bytes'))}  "
            f"pressure {mem.get('pressure', 0.0):.2f}")
    if mem.get("budget_bytes"):
        head += (f" (budget {_fmt_bytes(mem['budget_bytes'])}, "
                 f"{mem.get('budget_source') or '?'})")
    out = [head]
    pairs = "  ".join(f"{owner} {_fmt_bytes(n)}"
                      for owner, n in sorted(owned.items()) if n)
    if pairs:
        out.append(f"  owned  {pairs}")
    return out


def _staleness_compact(hist: dict) -> str:
    body = ",".join(f"{k[3:]}:{n}" for k, n in hist.items()
                    if k.startswith("le:") and n)
    return "{" + body + "}"


def render(status: dict, address: str = "") -> str:
    """One plain-text screen for a ``status`` payload (PS or serving kind) —
    the single rendering path behind ``--once`` and the live loop, so tests
    pin exactly what operators see."""
    kind = status.get("kind", "?")
    reg = status.get("registry", {}) or {}
    lines = [f"adtop — {kind} server {address}  "
             f"up {_fmt_age(status.get('uptime_s', 0))}  "
             f"{time.strftime('%H:%M:%S')}"]
    if status.get("error"):
        # A failed poll (live loop) must say WHY on screen, not silently
        # blank the tables — the operator needs refused-vs-timeout-vs-dead.
        lines.append(f"ERROR    {status['error']}")
    wire = status.get("wire") or {}
    if wire:
        lines.append(f"wire     tx {wire.get('bytes_sent', 0):,}B/"
                     f"{wire.get('msgs_sent', 0)}msg  "
                     f"rx {wire.get('bytes_received', 0):,}B/"
                     f"{wire.get('msgs_received', 0)}msg")
    saved = reg.get("ps.wire.bytes_saved", 0)
    if saved:
        # The push compressor's accounting (in-process workers mirror into
        # this registry; absent — exact wire — the line stays off screen).
        lines.append(f"compress saved {int(saved):,}B  "
                     f"quantized {int(reg.get('ps.wire.bytes_quantized', 0)):,}B"
                     f"  {reg.get('wire.quantize_s', 0.0):.3f}s quantize")
    if kind == "ps":
        bound = status.get("staleness_bound")
        version = status.get("version")
        head = f"gate     bound {bound if bound is not None else 'inf'}"
        if version is not None:
            head += f"  version {version}"
        shards = status.get("shard_versions")
        if shards:
            head += f"  shards {shards}"
        lines.append(head)
        per_worker = status.get("per_worker", {}) or {}
        if per_worker:
            lines.append("worker   last-seen  lag  staleness            wire")
            for wid in sorted(per_worker, key=str):
                w = per_worker[wid]
                seen = _fmt_age(w["last_seen_s"]) \
                    if "last_seen_s" in w else "?"
                lag = w.get("lag", "?")
                stal = _staleness_compact(w.get("staleness", {}) or {})
                wired = w.get("wire") or {}
                lines.append(
                    f"  w{wid:<5} {seen:>9}  {lag!s:>3}  {stal:<20} "
                    f"rx {wired.get('bytes_received', 0):,}B")
    elif kind == "serve":
        cap = status.get("capacity", 0)
        in_flight = status.get("in_flight", []) or []
        lines.append(f"queue    depth {status.get('queue_depth', 0)}  "
                     f"slots {len(in_flight)}/{cap}  "
                     f"mode {status.get('mode', '?')}  "
                     f"engine {status.get('engine', '?')}")
        done = _counter(reg, "serve.requests.completed")
        rej = _counter(reg, "serve.requests.rejected")
        total = reg.get("serve.latency_s.total")
        if isinstance(total, dict):
            p50 = _hist_quantile(total, 0.5)
            p99 = _hist_quantile(total, 0.99)
            lines.append(
                f"slo      done {done or 0}  rejected {rej or 0}  "
                f"p50~ {f'{p50:.4g}' if p50 is not None else '-'}s  "
                f"p99~ {f'{p99:.4g}' if p99 is not None else '-'}s")
        used = _counter(reg, "serve.kv.pages_used")
        free = _counter(reg, "serve.kv.pages_free")
        if used is not None or free is not None:
            # Paged-KV plane (serving/paged.py): pool occupancy + the
            # prefix-cache hit ledger. Absent on a dense-slab engine.
            hits = _counter(reg, "serve.kv.prefix_hits") or 0
            misses = _counter(reg, "serve.kv.prefix_misses") or 0
            lines.append(f"kv       pages {int(used or 0)} used / "
                         f"{int(free or 0)} free  "
                         f"prefix hits {int(hits)} misses {int(misses)}")
        if in_flight:
            lines.append("request  slot   age  tokens  prompt")
            for r in in_flight:
                lines.append(f"  #{r.get('request_id', '?'):<6} "
                             f"{r.get('slot', '?')!s:>4} "
                             f"{_fmt_age(r.get('age_s', 0)):>5}  "
                             f"{r.get('tokens', 0):>6}  "
                             f"{r.get('prompt_len', 0):>6}")
    elif kind == "router":
        routed = _counter(reg, "serve.router.routed") or 0
        shed = _counter(reg, "serve.router.shed") or 0
        replayed = _counter(reg, "serve.router.replayed") or 0
        lines.append(f"router   routed {int(routed)}  shed {int(shed)}  "
                     f"replayed {int(replayed)}")
        replicas = status.get("replicas") or []
        if replicas:
            lines.append("replica              gen  in-flight  queue  state")
            for r in replicas:
                state = "down" if r.get("down") else (
                    "draining" if r.get("draining") else "up")
                lines.append(f"  {r.get('replica', '?'):<18} "
                             f"{r.get('generation', 0)!s:>4} "
                             f"{r.get('in_flight', 0)!s:>10} "
                             f"{r.get('queue_depth', 0)!s:>6}  {state}")
    lines.extend(_perf_lines(reg))
    lines.extend(_req_lines(reg, status.get("alerts") or {}))
    lines.extend(_health_lines(reg))
    lines.extend(_memory_lines(status))
    lines.extend(_alert_lines(status.get("alerts") or {}))
    lines.extend(_recovery_lines(status))
    events = status.get("events") or status.get("anomalies") or []
    if events:
        lines.append(f"events   ({len(events)} recorded, newest last)")
        lines.extend(_event_lines(events))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="adtop", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("address", nargs="?", default=None,
                    help="server host:port (default: AUTODIST_PS_ADDR, then "
                         "AUTODIST_SERVE_ADDR)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (headless/test mode)")
    ap.add_argument("--raw", action="store_true",
                    help="print one raw JSON status payload and exit")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds for the live screen (default 2)")
    args = ap.parse_args(argv)
    address = args.address
    if address is None:
        from autodist_tpu_torch import const
        address = str(const.ENV.AUTODIST_PS_ADDR.val) \
            or str(const.ENV.AUTODIST_SERVE_ADDR.val)
    if not address:
        print("adtop: no address given and neither AUTODIST_PS_ADDR nor "
              "AUTODIST_SERVE_ADDR is set", file=sys.stderr)
        return 2
    try:
        status = fetch_status(address)
    except Exception as e:
        print(f"adtop: cannot read status from {address}: {e}",
              file=sys.stderr)
        return 1
    if args.raw:
        print(json.dumps(status, default=str, indent=1))
        return 0
    if args.once:
        print(render(status, address))
        return 0
    try:
        while True:
            # ANSI clear + home: a live screen with zero terminal deps.
            sys.stdout.write("\x1b[2J\x1b[H" + render(status, address) + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
            try:
                status = fetch_status(address)
            except Exception as e:
                status = {"kind": "?", "error": str(e)}
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
