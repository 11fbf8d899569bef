"""Run every benchmark configuration the port has and print the table of
throughput numbers (the port's counterpart of ``examples/benchmark/run_all.py``).

    python -m autodist_tpu_torch.examples.benchmark.run_all                 # every row
    python -m autodist_tpu_torch.examples.benchmark.run_all --only resnet50,bert_base
    python -m autodist_tpu_torch.examples.benchmark.run_all --steps 30      # quicker, noisier
    python -m autodist_tpu_torch.examples.benchmark.run_all --list

Each row runs its entry point in a fresh subprocess (one AutoDist per
process) on the card, and the sweep parses the last rate and MFU it prints.
The rows are the JAX sweep's, ``lm1b_lstm`` included (``lm1b_train --model
lstm``, words/s). A row that is not ported would print "not ported" with
its ROADMAP item instead of a number (``--only`` with it exits non-zero);
none is left. ``--baseline FILE`` diffs each rate per
card against a snapshot of recorded bests (``{"threshold_pct": 2.0,
"rows": {name: {"rate": ...}}}``); there is no default: the repository's
``PERF_BASELINE.json`` holds TPU rates, which no H100 run is compared with.
"""

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Optional, Sequence

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
PACKAGE = "autodist_tpu_torch.examples"

RATE = r"([\d,]+\.?\d*)"
EXAMPLES_PER_SEC = RATE + r" examples/sec"


def _imagenet(*flags):
    return lambda s: ["-m", f"{PACKAGE}.benchmark.imagenet", *flags, "--steps", s,
                      "--log_every", s]


def _bert(*flags):
    return lambda s: ["-m", f"{PACKAGE}.benchmark.bert", *flags, "--steps", s,
                      "--log_every", s]


# name -> (argv builder over the step count, unit, rate regex), or the
# ROADMAP item of a row that is not ported.
CONFIGS = {
    "flagship": (lambda s: ["-m", f"{PACKAGE}.flagship_lm", "--steps", s],
                 "tokens/s", r'"value": ([\d.]+)'),
    "resnet50": (_imagenet("--model", "resnet50", "--strategy", "AllReduce",
                           "--batch_size", "256"), "examples/s", EXAMPLES_PER_SEC),
    "vgg16": (_imagenet("--model", "vgg16", "--strategy", "PartitionedPS",
                        "--batch_size", "256"), "examples/s", EXAMPLES_PER_SEC),
    "densenet121": (_imagenet("--model", "densenet121", "--batch_size", "128"),
                    "examples/s", EXAMPLES_PER_SEC),
    "inceptionv3": (_imagenet("--model", "inceptionv3", "--batch_size", "128"),
                    "examples/s", EXAMPLES_PER_SEC),
    "bert_base": (_bert("--size", "base", "--batch_size", "2048", "--accum", "8"),
                  "examples/s", EXAMPLES_PER_SEC),
    "bert_large": (_bert("--size", "large", "--batch_size", "128"),
                   "examples/s", EXAMPLES_PER_SEC),
    "lm1b_lstm": (lambda s: ["-m", f"{PACKAGE}.lm1b.lm1b_train", "--model", "lstm",
                             "--steps", s, "--log_every", s], "words/s", RATE + r" words/sec"),
    "ncf": (lambda s: ["-m", f"{PACKAGE}.benchmark.ncf", "--steps", s, "--log_every", s],
            "examples/s", EXAMPLES_PER_SEC),
    "moe": (lambda s: ["-m", f"{PACKAGE}.moe_lm", "--batch_size", "512", "--accum", "4",
                       "--steps", s, "--log_every", s], "tokens/s", RATE + r" tokens/sec"),
}


def not_ported(name: str) -> Optional[str]:
    """The message of a row that is not ported, else None."""
    row = CONFIGS[name]
    return f"not ported ({row})" if isinstance(row, str) else None


def parse_output(name: str, out: str) -> dict:
    """The row's result from its entry point's output: the last rate its
    pattern matches, and the MFU in percent (the ``mfu N.NN%`` line, or the
    flagship's ``"mfu": fraction``)."""
    _, unit, pattern = CONFIGS[name]
    matches = re.findall(pattern, out)
    if not matches:
        return {"name": name, "unit": unit, "rate": None, "mfu_pct": None,
                "error": "no rate found in output"}
    mfu_pct = None
    m = re.findall(r"mfu ([\d.]+)%", out)
    if m:
        mfu_pct = float(m[-1])
    else:
        m = re.findall(r'"mfu": ([\d.]+)', out)
        if m:
            mfu_pct = round(100.0 * float(m[-1]), 2)
    return {"name": name, "unit": unit, "rate": float(matches[-1].replace(",", "")),
            "mfu_pct": mfu_pct, "error": None}


def run_config(name: str, steps: str, attempts: int = 2) -> dict:
    """Run one row in a fresh subprocess from the repository root; a failed
    run is retried once (another row's process may still be releasing the
    card's memory)."""
    builder, unit, _ = CONFIGS[name]
    cmd = [sys.executable] + builder(steps)
    for attempt in range(attempts):
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        out = proc.stdout + proc.stderr
        if proc.returncode == 0:
            return parse_output(name, out)
        if attempt < attempts - 1:
            print(f"  {name}: attempt {attempt + 1} failed, retrying ...", flush=True)
    return {"name": name, "unit": unit, "rate": None, "mfu_pct": None,
            "error": out.strip().splitlines()[-1] if out.strip() else "failed"}


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", type=str, default="",
                        help="comma-separated subset of: " + ",".join(CONFIGS))
    parser.add_argument("--steps", type=int, default=60, help="steps per config")
    parser.add_argument("--json", type=str, default="",
                        help="also write results to this JSON file")
    parser.add_argument("--list", action="store_true", help="list configs and exit")
    parser.add_argument("--baseline", type=str, default="",
                        help="snapshot of per-card bests to diff against (default: no "
                             "comparison)")
    parser.add_argument("--update_baseline", action="store_true",
                        help="not ported: it waits on an H100 baseline file "
                             "(ROADMAP, Open)")
    args = parser.parse_args(argv)

    if args.list:
        for name in CONFIGS:
            print(f"{name}  {not_ported(name)}" if not_ported(name) else name)
        return []
    if args.update_baseline:
        parser.error("--update_baseline is not ported: it waits on an H100 baseline file "
                     "(ROADMAP.md, Open, not in a queue)")
    names = [n.strip() for n in args.only.split(",") if n.strip()] or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        parser.error(f"unknown configs {unknown}; valid: {sorted(CONFIGS)}")
    if args.only:
        missing = [f"{n}: {not_ported(n)}" for n in names if not_ported(n)]
        if missing:
            parser.error("; ".join(missing))

    results = []
    for name in names:
        if not_ported(name):
            results.append({"name": name, "rate": None, "mfu_pct": None,
                            "error": not_ported(name)})
            continue
        print(f"running {name} ...", flush=True)
        results.append(run_config(name, str(args.steps)))

    # The snapshot holds per-card rates: each row's rate over the cards it ran on.
    baseline, threshold, n_dev = {}, 2.0, 1
    if args.baseline:
        import torch
        with open(args.baseline) as f:
            snapshot = json.load(f)
        baseline, threshold = snapshot.get("rows", {}), snapshot.get("threshold_pct", 2.0)
        n_dev = max(torch.cuda.device_count(), 1)
    width = max(len(r["name"]) for r in results)
    regressions = []
    print()
    for r in results:
        if r["rate"] is None:
            print(f"{r['name']:<{width}}  "
                  + (r["error"] if not_ported(r["name"]) else f"FAILED: {r['error']}"))
            continue
        mfu = f"  mfu {r['mfu_pct']:.1f}%" if r["mfu_pct"] is not None else ""
        delta = ""
        best = baseline.get(r["name"], {}).get("rate")
        if best:
            pct = 100.0 * (r["rate"] / n_dev / best - 1.0)
            r["vs_best_pct"] = round(pct, 2)
            delta = f"  {pct:+.1f}% vs best"
            if pct < -threshold:
                delta += "  << REGRESSION"
                regressions.append((r["name"], pct))
        print(f"{r['name']:<{width}}  {r['rate']:>14,.1f} {r['unit']}{mfu}{delta}")
    if regressions:
        print(f"\n{len(regressions)} row(s) regressed more than {threshold}% vs "
              f"{args.baseline}: " + ", ".join(f"{n} ({p:+.1f}%)" for n, p in regressions))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
