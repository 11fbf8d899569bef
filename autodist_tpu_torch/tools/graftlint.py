"""graftlint — project-specific static analysis for autodist_tpu_torch.

Usage:
    python -m autodist_tpu_torch.tools.graftlint [paths...]  # text, baseline on
    python -m autodist_tpu_torch.tools.graftlint --format json ...   # (CI)
    python -m autodist_tpu_torch.tools.graftlint --format sarif ...
    python -m autodist_tpu_torch.tools.graftlint --explain GL001
    python -m autodist_tpu_torch.tools.graftlint --list-checks
    python -m autodist_tpu_torch.tools.graftlint --changed-only  # pre-commit
    python -m autodist_tpu_torch.tools.graftlint --write-baseline ...
    python -m autodist_tpu_torch.tools.graftlint --crosscheck ...
        # merge the port sanitizer's observed lock edges into GL002's graph

Default paths are the port's: autodist_tpu_torch, tests/test_torch_*.py and
chip_smoke.py (a path may be a glob).
Exit status: 0 = clean (only suppressed/baselined findings), 1 = new
findings, 2 = usage error. Findings are suppressed inline with
``# graftlint: disable=GLnnn(reason)`` — the reason is mandatory — and
grandfathered via autodist_tpu_torch/tools/graftlint_baseline.json (new
findings fail, old ones don't). The check catalog is ``--list-checks`` and
``--explain GLnnn``; docs/usage/static_analysis.md describes the JAX
package's analyzer, whose check IDs and directives these are.

Results are cached under ``.graftlint_cache/torch/`` keyed on file content hashes
plus the analyzer's own source hash, with a whole-program layer on top: an
unchanged tree re-lints in file-hash time (``--no-cache`` disables, the JSON
output reports hit/miss stats and wall time). ``--changed-only`` lints just
the git-modified files for pre-commit speed — whole-program registry checks
(GL009/GL011) are skipped there because a partial file set cannot prove a
producer/arm is missing, and the interprocedural GL001/GL002 pass sees only
call targets INSIDE the changed set (a cross-module hazard through an
unchanged helper surfaces in CI's full pass, not pre-commit); CI still runs
the full pass.
"""

import argparse
import json
import os
import subprocess
import sys

import fnmatch
import glob

from autodist_tpu_torch.analysis import core

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PATHS = ["autodist_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py"]
DEFAULT_BASELINE = os.path.join(ROOT, "autodist_tpu_torch", "tools",
                                "graftlint_baseline.json")
# Apart from the JAX package's cache, which keys on its own analyzer.
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".graftlint_cache", "torch")


def expand_paths(paths):
    """Paths with globs expanded (sorted); a glob matching nothing stays as
    written, so the lint fails on it as on any missing path."""
    out = []
    for p in paths:
        if not glob.has_magic(p):
            out.append(p)
            continue
        hits = sorted(glob.glob(p if os.path.isabs(p) else os.path.join(ROOT, p)))
        if not hits:
            out.append(p)
        elif os.path.isabs(p):
            out.extend(hits)
        else:
            out.extend(os.path.relpath(h, ROOT).replace(os.sep, "/") for h in hits)
    return out

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def changed_py_files():
    """Repo-relative .py files changed vs HEAD (tracked mods + untracked),
    restricted to the default path set; None when git is unavailable —
    BOTH git commands must succeed, or a transient failure of the
    untracked listing would silently drop exactly the new files a
    pre-commit run exists to lint."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=ROOT, capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=ROOT, capture_output=True, text=True, timeout=30)
        if diff.returncode != 0 or untracked.returncode != 0:
            return None
    except (OSError, subprocess.SubprocessError):
        return None
    names = set(diff.stdout.splitlines()) | set(untracked.stdout.splitlines())
    out = []
    for name in sorted(names):
        if not name.endswith(".py"):
            continue
        if not any(name == p or name.startswith(p.rstrip("/") + "/")
                   or fnmatch.fnmatchcase(name, p) for p in DEFAULT_PATHS):
            continue
        if os.path.isfile(os.path.join(ROOT, name)):
            out.append(name)
    return out


def to_sarif(result, checks) -> dict:
    """SARIF 2.1.0 for the NEW findings (the failing set — baselined and
    suppressed findings are by definition not actionable results)."""
    used = sorted({f.check for f in result.findings})
    rules = [{"id": cid,
              "name": cid,
              "shortDescription": {"text": checks[cid].title
                                   if cid in checks else cid},
              "helpUri": "docs/usage/static_analysis.md"}
             for cid in used]
    results = [{
        "ruleId": f.check,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line,
                           "startColumn": max(1, f.col + 1)}},
            "logicalLocations": ([{"fullyQualifiedName": f.scope}]
                                 if f.scope else []),
        }]} for f in result.findings]
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "docs/usage/static_analysis.md",
                "rules": rules}},
            "results": results,
        }],
    }


def run_crosscheck(paths, observed_path: str, fmt: str) -> int:
    """``--crosscheck``: merge the port sanitizer's observed lock-order edges
    (``autodist_tpu_torch/testing/sanitizer.py`` export) into GL002's static
    identity graph.

    A dedicated tool path, NOT part of ``lint_paths``: its input is a
    run-dependent artifact, so its results must never enter the lint result
    cache (the warm-cache CI assertion stays meaningful) or the baseline.
    Exit 1 on dynamic-only findings; unexercised static edges are
    informational (exit 0)."""
    from autodist_tpu_torch.analysis.checks import concurrency
    from autodist_tpu_torch.analysis.program import ProgramIndex

    records = []
    try:
        with open(observed_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "outer" in rec and "inner" in rec:
                    records.append(rec)
    except OSError as e:
        print(f"graftlint: --crosscheck cannot read observed edges "
              f"({e}); run a sanitizer-armed suite "
              f"(AUTODIST_SANITIZE=locks) first", file=sys.stderr)
        return 2

    modules = {}
    try:
        for path in core.iter_py_files(expand_paths(paths), ROOT):
            rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as fh:
                    source = fh.read()
            except (OSError, UnicodeDecodeError):
                continue
            mod = core.Module(path, rel, source)
            if mod.parse_error is None:
                modules[rel] = mod
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2

    program = ProgramIndex(modules)
    findings, unexercised = concurrency.crosscheck(program, records)

    if fmt == "json":
        print(json.dumps({
            "version": 1,
            "observed_edges": len(records),
            "modules": len(modules),
            "findings": [f.to_json() for f in findings],
            "unexercised": unexercised,
            "ok": not findings,
        }, indent=1))
        return 0 if not findings else 1

    for f in findings:
        print(f.render())
    for u in unexercised:
        print(f"graftlint: crosscheck: static edge "
              f"{u['outer']['path']}:{u['outer']['name']} -> "
              f"{u['inner']['path']}:{u['inner']['name']} "
              f"(established at {u['path']}:{u['line']}) was never observed "
              f"at runtime — the lock model has coverage the run didn't "
              f"earn")
    print(f"graftlint --crosscheck: {len(findings)} dynamic finding(s), "
          f"{len(unexercised)} unexercised static edge(s), "
          f"{len(records)} observed edge(s) over {len(modules)} module(s)")
    return 0 if not findings else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of grandfathered findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report baselined findings as failures too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "and exit 0")
    ap.add_argument("--explain", metavar="GLnnn",
                    help="print a check's rationale and exit")
    ap.add_argument("--list-checks", action="store_true")
    ap.add_argument("--check", action="append", metavar="GLnnn",
                    help="run only these checks (repeatable)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk result cache")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                    help="result cache directory (default: "
                         ".graftlint_cache/torch)")
    ap.add_argument("--crosscheck", action="store_true",
                    help="merge sanitizer-observed lock-order edges "
                         "(--observed) into GL002's static graph: "
                         "dynamic-only cycles and order contradictions "
                         "fail; unexercised static edges are reported "
                         "informationally")
    ap.add_argument("--observed",
                    default=os.path.join(DEFAULT_CACHE_DIR,
                                         "observed_locks.jsonl"),
                    help="observed-edges JSONL exported by a "
                         "sanitizer-armed run of the port "
                         "(AUTODIST_SANITIZE=locks; "
                         "autodist_tpu_torch.testing.sanitizer)")
    ap.add_argument("--changed-only", action="store_true",
                    help="lint only git-changed files (pre-commit mode). "
                         "Whole-program registry checks (GL009/GL011) are "
                         "skipped, and interprocedural GL001/GL002 see "
                         "only the changed files' import-closure-free "
                         "subset — CI's full pass remains the authority")
    args = ap.parse_args(argv)

    checks = core.all_checks()
    if args.list_checks:
        for cid in sorted(checks):
            kind = " [program]" if checks[cid].program else ""
            print(f"{cid}  {checks[cid].title}{kind}")
        return 0
    if args.explain:
        check = checks.get(args.explain)
        if check is None:
            print(f"unknown check {args.explain!r}; known: "
                  f"{', '.join(sorted(checks))}", file=sys.stderr)
            return 2
        print(f"{check.id} — {check.title}\n")
        print((check.doc or "(no documentation)").strip())
        return 0
    if args.check:
        unknown = [c for c in args.check if c not in checks]
        if unknown:
            print(f"unknown check(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
    if args.crosscheck:
        if args.format == "sarif":
            print("--crosscheck supports text/json output", file=sys.stderr)
            return 2
        return run_crosscheck(args.paths or DEFAULT_PATHS, args.observed,
                              args.format)

    skip_full_program = False
    partial_paths = False
    if args.changed_only:
        if args.paths:
            print("--changed-only derives its own path set; drop the "
                  "positional paths", file=sys.stderr)
            return 2
        if args.write_baseline:
            print("--changed-only + --write-baseline would rewrite the "
                  "FULL baseline from a partial file set, dropping every "
                  "grandfathered finding in unchanged files; run "
                  "--write-baseline over the full path set", file=sys.stderr)
            return 2
        if args.check and all(checks[c].full_program for c in args.check):
            print("--changed-only skips whole-program registry checks "
                  f"({', '.join(args.check)} — unsound on a partial file "
                  "set); this run would check NOTHING. Run them over the "
                  "full path set instead", file=sys.stderr)
            return 2
        changed = changed_py_files()
        if changed is None:
            print("graftlint: --changed-only needs git; falling back to "
                  "the full path set", file=sys.stderr)
            paths = expand_paths(DEFAULT_PATHS)
        elif not changed:
            print("graftlint: no changed .py files under the lint path set")
            return 0
        else:
            paths = changed
            skip_full_program = True
    else:
        paths = expand_paths(args.paths or DEFAULT_PATHS)
        # An explicit PARTIAL path set gets the --changed-only soundness
        # treatment: registry checks (GL009/GL011) over a subset cannot
        # prove a producer/arm is missing (reproduced: linting alerts.py
        # alone reports every shipped selector as dead), and a baseline
        # rewritten from a subset drops every grandfathered finding in the
        # unlinted rest. An explicit --check of a full-program check is an
        # informed opt-in and still honored. Paths are normalized first —
        # `autodist_tpu_torch/` from tab-completion IS the full set.
        norm = {os.path.normpath(p) for p in paths}
        if norm != {os.path.normpath(p) for p in expand_paths(DEFAULT_PATHS)}:
            partial_paths = True
            if args.write_baseline:
                print("--write-baseline over a partial path set would "
                      "rewrite the FULL baseline from partial findings; "
                      "run it over the default path set", file=sys.stderr)
                return 2
            if not args.check:
                skip_full_program = True
                print("graftlint: partial path set — whole-program "
                      "registry checks (GL009/GL011) skipped; the full "
                      "path set (or CI) checks them", file=sys.stderr)

    baseline = set() if (args.no_baseline or args.write_baseline) \
        else core.load_baseline(args.baseline)
    cache = None if args.no_cache else core.LintCache(args.cache_dir)
    try:
        result = core.lint_paths(paths, root=ROOT, baseline=baseline,
                                 checks=args.check, cache=cache,
                                 skip_full_program=skip_full_program)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if args.changed_only or partial_paths:
        # Baseline entries for files outside the linted subset are not
        # "stale" — they were simply not linted this run (and the prune
        # advice would point at --write-baseline, which partial runs
        # refuse).
        result.stale_baseline = []

    if args.write_baseline:
        core.write_baseline(args.baseline, result.findings)
        print(f"graftlint: wrote {len(result.findings)} grandfathered "
              f"finding(s) to {os.path.relpath(args.baseline, ROOT)}")
        return 0

    if args.format == "sarif":
        print(json.dumps(to_sarif(result, checks), indent=1))
        return 0 if result.ok else 1

    if args.format == "json":
        print(json.dumps({
            "version": 1,
            "files_checked": result.files_checked,
            "wall_time_s": result.wall_time_s,
            "cache": result.cache_info or {"enabled": False},
            "findings": [f.to_json() for f in result.findings],
            "baselined": [f.to_json() for f in result.baselined],
            "suppressed": [{"finding": f.to_json(), "reason": r}
                           for f, r in result.suppressed],
            "stale_baseline": result.stale_baseline,
            "ok": result.ok,
        }, indent=1))
        return 0 if result.ok else 1

    for f in result.findings:
        print(f.render())
    tail = (f"graftlint: {len(result.findings)} new finding(s) over "
            f"{result.files_checked} file(s)"
            f" ({len(result.suppressed)} suppressed, "
            f"{len(result.baselined)} baselined)"
            f" in {result.wall_time_s:.2f}s")
    if result.cache_info and result.cache_info.get("program_hit"):
        tail += " [cache: whole-program hit]"
    if result.stale_baseline:
        tail += (f"; {len(result.stale_baseline)} stale baseline entr"
                 f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
                 f"(fixed findings — prune with --write-baseline)")
    print(tail)
    if result.findings:
        print("explain a check: python -m autodist_tpu_torch.tools.graftlint "
              "--explain GLnnn; "
              "suppress with `# graftlint: disable=GLnnn(reason)`")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
