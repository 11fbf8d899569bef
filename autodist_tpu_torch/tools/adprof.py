"""adprof — summarize and diff autodist performance profiles.

Reads the schema-versioned per-run profile JSONs the attribution plane
writes (``telemetry.write_profile`` / ``AUTODIST_PROFILE_DIR``): per-program
static costs, phase-attribution series, MFU/roofline readings, and the env
manifest.

Usage:
    python -m autodist_tpu_torch.tools.adprof RUN.json                    # one-run summary
    python -m autodist_tpu_torch.tools.adprof BASE.json NEW.json          # regression diff
    python -m autodist_tpu_torch.tools.adprof BASE.json NEW.json --threshold 5
    python -m autodist_tpu_torch.tools.adprof RUN.json --predict          # cost-model check
    python -m autodist_tpu_torch.tools.adprof ... --json                  # machine-readable

Diff mode compares NEW against BASE and NAMES what moved: overall step time,
MFU, each attribution phase's per-step seconds (share x step time — so a
phase "regressed 40%" means the step spends 40% more wall time there), and
per-signature program costs/compile counts. Exit codes are the CI contract:

    0  no regression beyond --threshold (default 10%%)
    1  step time OR any phase regressed beyond the threshold
    2  usage / unreadable / non-profile input

A profile diffed against itself therefore always exits 0 (the ci.sh smoke).
``--predict`` runs the calibrated cost model's self-consistency probe
(telemetry/costmodel.py): calibrate from the profile, predict its own
program mix, report predicted-vs-measured step time.
"""

import argparse
import json
import sys

PHASES = ("compute", "comm", "host", "data_wait", "readback")


def load_profile(path: str) -> dict:
    """Read and validate one profile JSON; raises ValueError on schema
    mismatch (a trace.json or metrics.json fed by mistake must fail loudly,
    not diff as zeros)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != "autodist-profile":
        raise ValueError(f"{path}: not an autodist profile "
                         f"(schema={doc.get('schema') if isinstance(doc, dict) else None!r})")
    version = doc.get("schema_version")
    if version != 1:
        raise ValueError(f"{path}: unsupported profile schema_version "
                         f"{version!r} (this adprof reads version 1)")
    return doc


def _fmt_pct(x) -> str:
    return f"{100.0 * x:.1f}%" if x is not None else "n/a"


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{int(n)}B" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _phase_seconds(summary: dict) -> dict:
    """Per-step seconds each phase costs: share x step_s (0.0 when the
    profile recorded no periods)."""
    step_s = summary.get("step_s") or 0.0
    shares = summary.get("shares") or {}
    return {p: (shares.get(p) or 0.0) * step_s for p in PHASES}


def summarize(doc: dict) -> list:
    """Human lines for one profile."""
    s = doc.get("summary") or {}
    peaks = doc.get("peaks") or {}
    man = doc.get("manifest") or {}
    lines = [f"profile  host {man.get('host', '?')}  pid {man.get('pid', '?')}"
             f"  programs {len(doc.get('programs') or {})}"
             f"  periods {len(doc.get('periods') or [])}"]
    if s.get("steps_per_s") is not None:
        lines.append(f"rate     {s['steps_per_s']:.2f} steps/s  "
                     f"({1e3 * (s.get('step_s') or 0):.2f} ms/step, "
                     f"{s.get('steps', 0)} steps over "
                     f"{s.get('wall_s', 0):.1f}s)")
    if s.get("mfu") is not None or s.get("membw_util") is not None:
        lines.append(f"roofline mfu {_fmt_pct(s.get('mfu'))}  "
                     f"membw {_fmt_pct(s.get('membw_util'))}  "
                     f"(peaks: {peaks.get('source', '?')})")
    shares = s.get("shares")
    if shares:
        lines.append("attr     " + "  ".join(
            f"{p} {shares.get(p, 0.0):.3f}" for p in PHASES))
    for sig, rec in sorted((doc.get("programs") or {}).items()):
        fl = rec.get("flops")
        lines.append(
            f"  prog {sig} [{rec.get('kind', '?')}/x{rec.get('steps', 1)}] "
            f"{(fl / 1e9):.3f} GFLOP/dispatch " if fl else
            f"  prog {sig} [{rec.get('kind', '?')}/x{rec.get('steps', 1)}] "
            f"flops n/a ")
        lines[-1] += (f"dispatches {rec.get('dispatches', 0)}  "
                      f"source {rec.get('source') or '?'}")
    # Per-program memory ledger (the runner's memory_analysis() record):
    # args/out are the program's bound buffers, temp is the transient HBM
    # the cost model's peak_hbm_bytes adds to resident state. Absent on
    # backends that report no analysis — the table stays off.
    mem = [(sig, rec) for sig, rec in
           sorted((doc.get("programs") or {}).items())
           if any(rec.get(k) is not None
                  for k in ("argument_bytes", "output_bytes",
                            "temp_bytes", "generated_code_bytes"))]
    if mem:
        lines.append("memory   sig       args        out       temp"
                     "    codegen")
        for sig, rec in mem:
            lines.append(
                f"  {sig:<8}"
                f"{_fmt_bytes(rec.get('argument_bytes')):>9} "
                f"{_fmt_bytes(rec.get('output_bytes')):>10} "
                f"{_fmt_bytes(rec.get('temp_bytes')):>10} "
                f"{_fmt_bytes(rec.get('generated_code_bytes')):>10}")
        temps = [rec.get("temp_bytes") for _, rec in mem
                 if rec.get("temp_bytes") is not None]
        if temps:
            lines.append(f"  peak temp {_fmt_bytes(max(temps))} "
                         f"(the transient term of predicted peak HBM)")
    return lines


def diff(base: dict, new: dict, threshold_pct: float) -> dict:
    """Compare two profiles; returns {"regressions": [...], "improvements":
    [...], "lines": [...], "regressed": bool}. A regression is step time (or
    one phase's per-step seconds, or per-program compile count growth)
    increasing more than ``threshold_pct`` — phases below 2%% of the step
    are ignored as noise."""
    b, n = base.get("summary") or {}, new.get("summary") or {}
    lines, regressions, improvements = [], [], []

    def compare(label, bv, nv, unit="s", invert=False):
        """invert=True: bigger is better (MFU)."""
        if not bv or nv is None:
            return
        change = (nv - bv) / bv * 100.0
        worse = change < -threshold_pct if invert else change > threshold_pct
        better = change > threshold_pct if invert else change < -threshold_pct
        arrow = f"{bv:.6g} -> {nv:.6g} {unit} ({change:+.1f}%)"
        lines.append(f"  {label:<12} {arrow}")
        if worse:
            regressions.append({"what": label, "base": bv, "new": nv,
                                "change_pct": round(change, 2)})
        elif better:
            improvements.append({"what": label, "base": bv, "new": nv,
                                 "change_pct": round(change, 2)})

    compare("step_time", b.get("step_s"), n.get("step_s"))
    compare("mfu", b.get("mfu"), n.get("mfu"), unit="", invert=True)
    bp, np_ = _phase_seconds(b), _phase_seconds(n)
    step_b = b.get("step_s") or 0.0
    for p in PHASES:
        # A phase that is noise-level in BOTH runs cannot "regress 300%"
        # off a microsecond base; require it to matter in at least one run.
        if max(bp[p], np_[p]) < 0.02 * max(step_b, n.get("step_s") or 0.0):
            continue
        compare(f"phase:{p}", bp[p], np_[p])
    progs_b = base.get("programs") or {}
    progs_n = new.get("programs") or {}
    for sig in sorted(set(progs_b) & set(progs_n)):
        compare(f"prog:{sig}:flops", progs_b[sig].get("flops"),
                progs_n[sig].get("flops"), unit="flops")
    only_new = sorted(set(progs_n) - set(progs_b))
    if only_new:
        lines.append(f"  new program signature(s) in NEW: {only_new} "
                     f"(recompiles the base run never paid)")
    return {"regressions": regressions, "improvements": improvements,
            "lines": lines, "regressed": bool(regressions)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="adprof", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("base", help="profile JSON (the baseline in diff mode)")
    ap.add_argument("new", nargs="?", default=None,
                    help="second profile: diff NEW against BASE")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold in percent (default 10)")
    ap.add_argument("--predict", action="store_true",
                    help="run the calibrated cost model's self-consistency "
                         "probe on the (first) profile")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    try:
        base = load_profile(args.base)
        new = load_profile(args.new) if args.new else None
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"adprof: {e}", file=sys.stderr)
        return 2

    if new is None:
        out = {"summary": base.get("summary"),
               "programs": base.get("programs")}
        if args.predict:
            from autodist_tpu_torch.telemetry import costmodel
            pred = costmodel.predict_from_profile(base)
            out["predict"] = pred
        if args.json:
            print(json.dumps(out, indent=1, default=str))
        else:
            print("\n".join(summarize(base)))
            if args.predict:
                pred = out["predict"]
                ratio = pred.get("ratio")
                print(f"predict  {1e3 * pred['step_s']:.3f} ms/step "
                      f"(measured "
                      f"{1e3 * (pred.get('measured_step_s') or 0):.3f}, "
                      f"ratio {ratio:.2f}x)  bound: {pred['bound']}"
                      if ratio is not None else
                      f"predict  {pred['step_s']:.6f} s/step  "
                      f"bound: {pred['bound']}")
        return 0

    result = diff(base, new, args.threshold)
    if args.json:
        print(json.dumps(result, indent=1, default=str))
    else:
        print(f"adprof diff: {args.base} -> {args.new} "
              f"(threshold {args.threshold:g}%)")
        print("\n".join(result["lines"]))
        for r in result["regressions"]:
            print(f"REGRESSION: {r['what']} {r['change_pct']:+.1f}% "
                  f"({r['base']:.6g} -> {r['new']:.6g})")
        if not result["regressed"]:
            print(f"no regression beyond {args.threshold:g}% "
                  f"({len(result['improvements'])} improvement(s))")
    return 1 if result["regressed"] else 0


if __name__ == "__main__":
    sys.exit(main())
