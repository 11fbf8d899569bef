"""adfleet — a multi-endpoint fleet console for autodist servers.

Where ``adtop`` watches ONE process, adfleet polls the ``status`` wire opcode
across N addresses concurrently and renders a merged screen: one row per
process (role, uptime, step rate, MFU, staleness bound/worst lag, serving
queue/slots, SLO p50/p99, active alerts), then FLEET-AGGREGATED serving
quantiles (latency histograms merged element-wise before the quantile — the
mathematically right aggregation; averaging per-replica p99s is not), the
union of active alerts, and the newest events across the fleet. This is the
signal surface a replica router reads: which replica to drain, who
is burning SLO budget, whether an alert names a culprit.

Usage:
    python -m autodist_tpu_torch.tools.adfleet HOST:PORT HOST:PORT ...   # live screen, 2s poll
    python -m autodist_tpu_torch.tools.adfleet A:1 B:2 --once            # one plain-text pass
    python -m autodist_tpu_torch.tools.adfleet A:1 B:2 --raw             # one JSON pass
    python -m autodist_tpu_torch.tools.adfleet --endpoints A:1,B:2 --interval 5

With no addresses, ``AUTODIST_PS_ADDR`` and ``AUTODIST_SERVE_ADDR`` seed the
list. A dead endpoint renders as an error row — the fleet view must survive
any one replica being the incident.
"""

import argparse
import concurrent.futures
import json
import sys
import time

# The single-endpoint console's formatters, reused so the two consoles
# cannot drift on how an age or an alert line reads.
from autodist_tpu_torch.tools.adtop import _alert_line, _fmt_age


def fetch_fleet(addresses, timeout: float = 2.0) -> dict:
    """``{address: status-payload-or-{"error": ...}}`` polled CONCURRENTLY —
    a fleet poll must take one slowest-endpoint round-trip, not the sum.

    ``timeout`` is deliberately SHORT (the PS client retries a refused
    connect until this deadline — right for a worker waiting on its chief,
    wrong for a liveness poll): a crashed replica must read as DOWN in a
    couple of seconds, not stall every screen refresh for the worker-grade
    10s."""
    from autodist_tpu_torch.parallel.ps_transport import _PSClient

    def one(address):
        # read_timeout too: a hung-but-accepting server must read as DOWN,
        # not park the poll thread on a reply that never comes.
        client = _PSClient(address, connect_timeout=timeout,
                           read_timeout=timeout)
        try:
            return client.call("status")[0]
        finally:
            client.close()

    out = {}
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(16, max(1, len(addresses)))) as pool:
        futs = {pool.submit(one, a): a for a in addresses}
        for fut in concurrent.futures.as_completed(futs):
            addr = futs[fut]
            try:
                out[addr] = fut.result()
            except Exception as e:
                out[addr] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _fmt_q(value) -> str:
    return f"{value * 1e3:.0f}ms" if value is not None else "-"


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GB"


def _row(address: str, status: dict) -> str:
    from autodist_tpu_torch.telemetry import metrics as _metrics
    if status.get("error") and "kind" not in status:
        return f"  {address:<22} DOWN   {status['error']}"
    kind = status.get("kind", "?")
    reg = status.get("registry", {}) or {}
    cols = [f"  {address:<22} {kind:<6}",
            f"up {_fmt_age(status.get('uptime_s', 0)):>6}"]
    rate = reg.get("train.steps_per_s")
    cols.append(f"steps/s {rate:7.2f}" if isinstance(rate, (int, float))
                else "steps/s       -")
    mfu = reg.get("train.mfu")
    cols.append(f"mfu {100.0 * mfu:5.1f}%" if isinstance(mfu, (int, float))
                else "mfu      -")
    if kind == "ps":
        lags = [w.get("lag") for w in (status.get("per_worker") or {}).values()
                if isinstance(w.get("lag"), (int, float))]
        bound = status.get("staleness_bound")
        cols.append(f"lag {max(lags) if lags else 0}/"
                    f"{bound if bound is not None else 'inf'}")
    elif kind == "serve":
        cap = status.get("capacity", 0)
        busy = len(status.get("in_flight") or [])
        cols.append(f"q {status.get('queue_depth', 0)} "
                    f"slots {busy}/{cap}")
        total = reg.get("serve.latency_s.total")
        if isinstance(total, dict):
            cols.append(f"p50 {_fmt_q(_metrics.quantile(total, 0.5))} "
                        f"p99 {_fmt_q(_metrics.quantile(total, 0.99))}")
        shares = [(p, reg.get(f"serve.attr.{p}"))
                  for p in ("wire", "queue", "prefill", "decode")]
        shares = [(p, v) for p, v in shares if isinstance(v, (int, float))]
        if any(v for _, v in shares):
            # Compact phase-attribution fingerprint (serve.attr.* — the
            # reqtrace plane's per-round shares): where this replica's
            # request time goes, w/q/p/d. Un-armed replicas keep the
            # column off, like recov/wiresave.
            cols.append("attr " + "/".join(
                f"{p[0]}{v:.2f}".replace(f"{p[0]}0.", f"{p[0]}.")
                for p, v in shares))
        used = reg.get("serve.kv.pages_used")
        free = reg.get("serve.kv.pages_free")
        if isinstance(used, (int, float)) or isinstance(free, (int, float)):
            # Paged-KV occupancy fingerprint (dense-slab replicas keep the
            # column off, like recov/wiresave).
            cols.append(f"pages {int(used or 0)}/"
                        f"{int(used or 0) + int(free or 0)}")
    elif kind == "router":
        replicas = status.get("replicas") or []
        n_up = sum(1 for r in replicas
                   if not r.get("down") and not r.get("draining"))
        cols.append(f"replicas {n_up}/{len(replicas)} up")
        shed = reg.get("serve.router.shed")
        routed = reg.get("serve.router.routed")
        if isinstance(routed, (int, float)):
            cols.append(f"routed {int(routed)}")
        if isinstance(shed, (int, float)) and shed:
            # Admission sheds are the router's overload fingerprint: a
            # nonzero column is the signal to raise max_replicas or shrink
            # the offered load, BEFORE p99 melts.
            cols.append(f"shed {int(shed)}")
    mem = status.get("memory") or {}
    if mem.get("live_bytes") or mem.get("owned"):
        # Memory-plane fingerprint: worst-device HBM used vs the booked
        # budget (the mem.pressure ratio's own numbers). Processes whose
        # plane never armed keep the column off, like recov/wiresave.
        devs = mem.get("devices") or {}
        used = max((d.get("bytes_in_use", 0) for d in devs.values()),
                   default=mem.get("live_bytes", 0))
        limit = max((d.get("bytes_limit", 0) for d in devs.values()),
                    default=mem.get("budget_bytes", 0))
        col = f"hbm {_fmt_bytes(used)}"
        if limit:
            col += f"/{_fmt_bytes(limit)}"
        cols.append(col)
    active = (status.get("alerts") or {}).get("active") or []
    if active:
        cols.append("ALERT " + ",".join(sorted(a.get("rule", "?")
                                               for a in active)))
    saved = reg.get("ps.wire.bytes_saved")
    if saved:
        # Compact compression fingerprint: a replica pushing quantized or
        # sparse gradients shows its cumulative wire savings in the fleet
        # table (exact-wire replicas keep the column off, like recov).
        cols.append(f"wiresave {_fmt_bytes(saved)}")
    counts = (status.get("recovery") or {}).get("counts") or {}
    if any(counts.values()):
        # Compact recovery fingerprint: evictions/rejoins/rollbacks/respawns
        # this process has performed — a replica that has been self-healing
        # is visible in the fleet table, not just on its own adtop screen.
        cols.append("recov E%d/J%d/B%d/S%d" % (
            counts.get("evicted", 0), counts.get("rejoined", 0),
            counts.get("rollbacks", 0), counts.get("respawns", 0)))
    return "  ".join(cols)


def render(fleet: dict) -> str:
    """One plain-text screen for a fleet poll — the single rendering path
    behind ``--once`` and the live loop (the adtop contract: tests pin
    exactly what operators see)."""
    from autodist_tpu_torch.telemetry import metrics as _metrics
    lines = [f"adfleet — {len(fleet)} endpoint(s)  "
             f"{time.strftime('%H:%M:%S')}"]
    lines.append("  endpoint               role   uptime    throughput ...")
    for addr in sorted(fleet):
        lines.append(_row(addr, fleet[addr]))

    # Fleet-aggregated serving quantiles: merge the latency histograms
    # element-wise across replicas, THEN take the quantile (the only
    # aggregation that answers "what latency does a fleet user see").
    hists = [(s.get("registry") or {}).get("serve.latency_s.total")
             for s in fleet.values() if isinstance(s, dict)]
    hists = [h for h in hists if isinstance(h, dict)]
    if hists:
        merged = _metrics.merge_histograms(hists)
        count = merged.get("count", 0)
        lines.append(
            f"fleet    serve n={len(hists)}  requests {count}  "
            f"p50 {_fmt_q(_metrics.quantile(merged, 0.5))}  "
            f"p99 {_fmt_q(_metrics.quantile(merged, 0.99))}")

    # The union of active alerts, who is firing them, and the newest events.
    firing = []
    for addr in sorted(fleet):
        for a in ((fleet[addr].get("alerts") or {}).get("active") or []):
            firing.append((addr, a))
    if firing:
        lines.append(f"alerts   {len(firing)} active")
        for addr, a in firing:
            # adtop's shared alert-line formatter with the endpoint spliced
            # in — two consoles, one rendering of an alert record.
            lines.append(_alert_line(a, where=f" @ {addr}"))
    events = []
    for addr, s in fleet.items():
        for rec in (s.get("events") or [])[-3:]:
            if isinstance(rec, dict):
                events.append((rec.get("t_wall_s") or 0, addr, rec))
    # Sort on (time, endpoint) ONLY: two same-millisecond events would
    # otherwise fall through to comparing the record dicts and raise.
    for t_wall, addr, rec in sorted(events, key=lambda e: e[:2])[-5:]:
        when = time.strftime("%H:%M:%S", time.localtime(t_wall)) \
            if t_wall else "--:--:--"
        lines.append(f"  {when}  {rec.get('name', 'event')} @ {addr}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="adfleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("addresses", nargs="*", default=[],
                    help="server host:port endpoints (default: "
                         "AUTODIST_PS_ADDR + AUTODIST_SERVE_ADDR)")
    ap.add_argument("--endpoints", default="",
                    help="comma-separated host:port list (merged with "
                         "positional addresses)")
    ap.add_argument("--once", action="store_true",
                    help="print one merged snapshot and exit")
    ap.add_argument("--raw", action="store_true",
                    help="print one raw JSON fleet payload and exit")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds for the live screen (default 2)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint connect/read deadline seconds "
                         "(default 2 — a dead replica reads DOWN fast)")
    args = ap.parse_args(argv)
    addresses = list(args.addresses)
    addresses += [a for a in args.endpoints.split(",") if a]
    if not addresses:
        from autodist_tpu_torch import const
        addresses = [a for a in (str(const.ENV.AUTODIST_PS_ADDR.val),
                                 str(const.ENV.AUTODIST_SERVE_ADDR.val)) if a]
    if not addresses:
        print("adfleet: no endpoints given and neither AUTODIST_PS_ADDR nor "
              "AUTODIST_SERVE_ADDR is set", file=sys.stderr)
        return 2
    fleet = fetch_fleet(addresses, timeout=args.timeout)
    if args.raw:
        print(json.dumps(fleet, default=str, indent=1))
        return 0
    if args.once:
        print(render(fleet))
        # Every endpoint down is an exit-code failure (scripts gate on it);
        # a PARTIALLY-down fleet still renders and exits 0.
        all_down = all(isinstance(s, dict) and s.get("error")
                       and "kind" not in s for s in fleet.values())
        return 1 if all_down else 0
    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H" + render(fleet) + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
            fleet = fetch_fleet(addresses, timeout=args.timeout)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
