"""Bounded-staleness async parameter-server training across two processes
(the port's counterpart of ``examples/async_ps_train.py``).

    python -m autodist_tpu_torch.examples.async_ps_train                # cuda:0
    python -m autodist_tpu_torch.examples.async_ps_train --device cpu   # the host

1. The chief builds ``PS(sync=True, staleness=2)`` for a two-node loopback
   resource spec. ``create_distributed_session`` sees the non-synchronous
   regime: the processes stay independent programs joined by the chief's
   parameter service, not one process group.
2. The Coordinator re-executes this module on the second "node" with the
   worker role env and the PS transport address.
3. Both processes call ``step(batch)``. The chief steps its own worker slot;
   the worker process pulls parameters over the TCP transport, computes
   gradients on its device and pushes them back. The chief's staleness gate
   keeps any worker at most ``--staleness`` steps ahead of the slowest.
4. Pulls are version-conditional (``read_if_newer``): a worker whose gate
   opened with no update in between reuses its cached parameters.

The chief prints ``async PS summary: {...}``: the applied update count (both
processes' steps), each side's losses and the worker's wire bytes. Both
"nodes" name card 0 (``gpus: [0]``); ``--device cpu`` runs both on the host.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from autodist_tpu_torch import AutoDist, const
from autodist_tpu_torch.strategy import PS

# Two "nodes" on loopback; on a real cluster these are distinct hosts (with
# ssh_config entries) and the same program runs unchanged on each.
SPEC = ("nodes: [{address: localhost, gpus: [0], chief: true}, "
        "{address: 127.0.0.1, gpus: [0]}]")
STALENESS = 2
STEPS = 8
LR = 0.05
DIM = 64


def make_batch(step: int):
    rng = np.random.RandomState(100 + step)
    x = rng.randn(32, DIM).astype(np.float32)
    w_true = np.linspace(-1.0, 1.0, DIM, dtype=np.float32)[:, None]
    y = x @ w_true + 0.5 + 0.05 * rng.randn(32, 1).astype(np.float32)
    return {"x": x, "y": y}


def loss_fn(p, b):
    pred = b["x"] @ p["w"] + p["b"]
    return ((b["y"] - pred) ** 2).mean()


def _worker_report_path() -> str:
    return os.path.join(const.DEFAULT_WORKING_DIR, "async_ps_worker_report.json")


def main(steps: int = STEPS, staleness: int = STALENESS, out_path: str = None,
         device=None) -> dict:
    """Train; on the chief return (and print) the summary, on the worker
    write its report and return it."""
    if not const.is_worker():
        # A stale report from an earlier run must not mask a worker crash.
        try:
            os.remove(_worker_report_path())
        except FileNotFoundError:
            pass
    ad = AutoDist(SPEC, PS(sync=True, staleness=staleness), device=device)
    params = {"w": torch.zeros(DIM, 1), "b": torch.zeros(1)}
    step = ad.function(loss_fn, params, lambda p: torch.optim.Adam(p, lr=LR, eps=1e-8),
                       example_batch=make_batch(0))

    role = "worker" if const.is_worker() else "chief"
    losses = []
    for i in range(steps):
        loss = float(step(make_batch(i)))
        losses.append(loss)
        print(f"[{role}] step {i}: loss={loss:.4f}", flush=True)

    if const.is_worker():
        # The worker's step drives a RemotePSWorker; its wire accounting goes
        # back to the chief through a file.
        remote = step.runner._remote_worker
        wire = remote.wire_bytes if remote is not None else (0, 0)
        report = {"worker_losses": losses, "wire_sent": wire[0], "wire_received": wire[1]}
        os.makedirs(os.path.dirname(_worker_report_path()), exist_ok=True)
        with open(_worker_report_path(), "w") as f:
            json.dump(report, f)
        return report

    if not ad._coordinator.join(timeout=300.0):
        raise RuntimeError("worker process did not finish")
    runner = step.runner
    deadline = time.time() + 30
    while runner.service.updates_applied < 2 * steps and time.time() < deadline:
        time.sleep(0.05)
    try:
        with open(_worker_report_path()) as f:
            worker = json.load(f)
    except FileNotFoundError:
        worker = {}
    summary = {
        "applied_updates": runner.service.updates_applied,
        "chief_steps": steps,
        "worker_steps": len(worker.get("worker_losses", [])),
        "chief_final_loss": losses[-1],
        "worker_final_loss": (worker.get("worker_losses") or [None])[-1],
        "worker_wire_sent_bytes": worker.get("wire_sent"),
        "worker_wire_received_bytes": worker.get("wire_received"),
    }
    print("async PS summary:", json.dumps(summary, indent=2), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f)
    assert summary["applied_updates"] == 2 * steps, summary
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--staleness", type=int, default=STALENESS)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' for the host)")
    args, _ = parser.parse_known_args()
    main(args.steps, args.staleness, args.out, args.device)
