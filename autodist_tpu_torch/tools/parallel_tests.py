"""Shard the port's tests (``tests/test_torch_*.py``) across N pytest
processes.

The tail of the port's suite is its multi-process tests (gloo ranks
spawned per file): wall-clock there is process startup and rendezvous
latency, not CPU, so file-level sharding across a few pytest processes
overlaps those waits with the compute-heavy files. This script needs no
pytest plugin: greedy bin-packing of test FILES by size (a cheap proxy for
runtime) into N shards, one pytest subprocess each, combined exit status.
The port's graftlint runs first, as its own stage.

    python -m autodist_tpu_torch.tools.parallel_tests [-n 4] [-- extra pytest args]

File-level sharding is safe because every test file is hermetic (own tmp
dirs, ephemeral ports, fresh AutoDist instances).
"""

import argparse
import glob
import os
import subprocess
import sys
import threading
import time

from autodist_tpu_torch.testing.sanitizer import san_lock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shard_files(n: int):
    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    if not files:
        raise SystemExit("no test files found")
    # Greedy: biggest file into the lightest shard. Size correlates with
    # runtime well enough; the multiprocess file dominates either way.
    files.sort(key=os.path.getsize, reverse=True)
    shards = [[] for _ in range(n)]
    weights = [0] * n
    for f in files:
        i = weights.index(min(weights))
        shards[i].append(f)
        weights[i] += os.path.getsize(f)
    return [s for s in shards if s]


def run_lint():
    """graftlint as a distinct pre-stage: static-analysis findings are NOT
    test failures — they fail with their own banner and exit code (2) so a
    red run is immediately attributable. Fast (pure AST)."""
    print("lint: graftlint (static analysis) ...")
    proc = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.tools.graftlint"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode == 0:
        print(f"lint: OK ({proc.stdout.strip().splitlines()[-1]})")
        return True
    print("lint: FAILED — graftlint findings (static analysis, not test "
          "failures):")
    print(proc.stdout.rstrip())
    return False


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", type=int, default=4, help="shard count")
    parser.add_argument("--no-lint", action="store_true",
                        help="skip the graftlint pre-stage (when a lint "
                             "stage of its own runs it)")
    parser.add_argument("rest", nargs="*", help="extra pytest args (after --)")
    args = parser.parse_args(argv)

    lint_ok = True if args.no_lint else run_lint()
    shards = shard_files(args.n)
    t0 = time.time()
    procs = []
    logs = []
    for i, shard in enumerate(shards):
        log = open(os.path.join(ROOT, f".pytest-shard-{i}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, "-m", "pytest", "-q", *args.rest, *shard]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                      stderr=subprocess.STDOUT))
        print(f"shard {i}: {len(shard)} files "
              f"({', '.join(os.path.basename(f) for f in shard[:3])}...)")

    # One waiter thread per shard (sanitizer-factory lock around the shared
    # result map) so a finished shard reports immediately instead of behind
    # a slower earlier one. The finally is the teardown discipline the
    # thread-leak fence flagged: an interrupt used to abandon the remaining
    # shard PROCESSES and the waiters parked on them — now the children are
    # terminated and every waiter joined before main exits.
    results = {}
    results_lock = san_lock()

    def wait_one(i, p, log):
        rc = p.wait()
        log.close()
        with open(log.name) as f:
            tail = f.read().strip().splitlines()
        with results_lock:
            results[i] = (rc, tail, log.name)
        summary = tail[-1] if tail else "(no output)"
        print(f"shard {i}: rc={rc}  {summary}")

    waiters = [threading.Thread(target=wait_one, args=(i, p, log),
                                name=f"shard-waiter-{i}")
               for i, (p, log) in enumerate(zip(procs, logs))]
    try:
        for t in waiters:
            t.start()
        for t in waiters:
            t.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for t in waiters:
            if t.is_alive():
                t.join(timeout=30.0)

    failed = False
    for i in sorted(results):
        rc, tail, log_name = results[i]
        if rc != 0:
            failed = True
            print(f"--- shard {i} failures (see {log_name}) ---")
            print("\n".join(line for line in tail if "FAILED" in line
                            or "ERROR" in line) or "\n".join(tail[-15:]))
    print(f"total wall clock: {time.time() - t0:.0f}s across "
          f"{len(shards)} shards")
    if not lint_ok:
        print("lint: FAILED (graftlint — rerun: python -m autodist_tpu_torch.tools.graftlint; "
              "distinct from the test results above)")
    if failed:
        return 1      # test failures (lint status printed separately)
    return 2 if not lint_ok else 0


if __name__ == "__main__":
    sys.exit(main())
