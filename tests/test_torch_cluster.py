"""The port's cluster runtime (autodist_tpu_torch.cluster, coordinator,
recovery, testing.faults, strategy serialization and the multihost join)
against the JAX package's, with one subprocess test: two processes from a
two-node loopback spec, the port's ``async_ps_train`` example and a
synchronous gloo run. Every comparison with JAX is exact."""

import json
import os
import random
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from autodist_tpu import cluster as jax_cluster
from autodist_tpu import coordinator as jax_coordinator
from autodist_tpu.resource_spec import ResourceSpec as JaxResourceSpec
from autodist_tpu_torch import AutoDist, cluster, const, coordinator
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.parallel import multihost, recovery
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import PS, AllReduce, Parallax, PartitionedPS
from autodist_tpu_torch.strategy.base import Strategy
from autodist_tpu_torch.testing import faults
from autodist_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = """
nodes:
  - address: 10.0.0.2
    gpus: [0, 1]
    ssh_config: gpu
  - address: 10.0.0.1
    gpus: [0, 1, 2, 3]
    chief: true
  - address: 127.0.0.3
    cpus: [0]
ssh:
  gpu:
    username: me
    port: 2222
    key_file: /keys/id
"""


def test_addresses_and_cluster_spec_match_jax():
    """``is_local_address`` on loopback, own and foreign names, and the
    cluster spec (deterministic process ids, coordinator, device counts)
    from the same YAML."""
    for address in ("localhost", "127.0.0.1", "127.0.0.5", "::1", "0.0.0.0", "10.1.2.3",
                    "example.invalid", "not an address"):
        assert cluster.is_local_address(address) == jax_cluster.is_local_address(address)
    assert cluster._own_addresses() == jax_cluster._own_addresses()
    ours = cluster.Cluster(ResourceSpec(SPEC))
    theirs = jax_cluster.Cluster(JaxResourceSpec(SPEC))
    assert ours.cluster_spec == theirs.cluster_spec
    assert ours.num_processes == theirs.num_processes == 3
    assert ours._ssh_command("10.0.0.2") == theirs._ssh_command("10.0.0.2")


class _RecordingCluster:
    """A cluster stand-in that records launches instead of running them."""

    def __init__(self, real):
        self.cluster_spec, self.num_processes = real.cluster_spec, real.num_processes
        self.launched = []

    def remote_copy(self, local_path, remote_dir, address):
        # The directory is each package's own working directory.
        self.launched.append(("copy", address))

    def remote_exec(self, cmd, address, env=None):
        self.launched.append((cmd[1:], address, env))
        return type("Proc", (), {"wait": lambda self, timeout=None: 0})()


class _Strategy:
    id = "20260101T000000M000000"

    def serialize(self):
        return "/unused"


def test_launch_clients_sets_the_jax_env(monkeypatch):
    """The launch of every non-chief node: the same command tail, addresses,
    copies and role/bootstrap env (keys and values) as the JAX coordinator,
    extra env included."""
    monkeypatch.setenv("SYS_DATA_PATH", "/data")
    spec = "nodes: [{address: 127.0.0.1, gpus: [0], chief: true}, " \
           "{address: 127.0.0.2, gpus: [0]}, {address: 10.9.9.9, gpus: [0]}]"
    runs = []
    for mod, rs, cl in ((coordinator, ResourceSpec, cluster),
                        (jax_coordinator, JaxResourceSpec, jax_cluster)):
        recording = _RecordingCluster(cl.Cluster(rs(spec)))
        coord = mod.Coordinator(_Strategy(), recording, argv=["train.py", "--x", "1"])
        coord.launch_clients(extra_env={"AUTODIST_PS_ADDR": "127.0.0.1:5555"})
        runs.append(recording.launched)
    assert runs[0] == runs[1]
    # Sorted node order: the remote node's strategy copy, then its launch.
    assert [entry[1] for entry in runs[0]] == ["10.9.9.9", "10.9.9.9", "127.0.0.2"]
    assert runs[0][-1][2]["AUTODIST_PROCESS_ID"] == "2"
    assert coordinator.relaunch_command(["x.py"]) == [sys.executable, "x.py"]


def test_respawn_policy_budget_and_delays_match_jax(monkeypatch):
    monkeypatch.setenv("AUTODIST_RECOVER_MAX", "3")
    grants = []
    for mod in (coordinator, jax_coordinator):
        random.seed(7)
        policy = mod.RespawnPolicy(base_s=0.5, cap_s=4.0)
        grants.append((policy.budget(), [policy.grant("w1") for _ in range(5)],
                       policy.grant("w2")))
    assert grants[0] == grants[1]
    assert grants[0][1][3:] == [None, None]
    assert recovery.recovery_snapshot()["counts"]["respawns"] >= 4


def _linear_runner():
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=PS(sync=False), device="cpu")
    return ad.create_distributed_session(lambda p, b: (b["x"] @ p["w"]).mean(),
                                         {"w": torch.zeros(2)},
                                         lambda p: torch.optim.SGD(p, lr=0.1))


def test_recovery_and_fault_harness():
    """Backoff stays bounded; an eviction books once; the snapshot ring
    bounds and copies; rollback escalates by re-raising, and snapshots
    through an armed flight recorder; the fault grammar parses and fires exactly
    ``count`` times; ``nan_grads`` NaN-fills a batch's floats (ints kept)
    through train()'s step."""
    assert all(0.0 <= recovery.backoff_s(a, 0.2, cap_s=2.0) <= 2.0 for a in range(20))
    from autodist_tpu_torch.parallel.staleness import StalenessController
    gate = StalenessController(2, staleness=1)
    before = recovery.recovery_snapshot()["counts"]["evicted"]
    assert recovery.evict(gate, 1, age_s=3.0)["worker"] == 1
    assert recovery.evict(gate, 1) is None
    assert recovery.recovery_snapshot()["counts"]["evicted"] == before + 1
    ring = recovery.SnapshotRing(keep=2, copy_fn=lambda s: {k: v.clone() for k, v in s.items()})
    for step in (1, 2, 3):
        ring.push(step, {"w": torch.full((2,), float(step))})
    assert len(ring) == 2 and ring.newest()[0] == 3
    step, state = ring.checkout()
    state["w"].zero_()
    assert ring.newest()[1]["w"][0] == 3.0
    signal = RuntimeError("anomaly")
    assert recovery.rollback(signal, ring, attempt=1, max_attempts=2)["w"][0] == 3.0
    with pytest.raises(RuntimeError, match="anomaly"):
        recovery.rollback(signal, ring, attempt=3, max_attempts=2)
    # With the flight recorder armed, a rollback snapshots the evidence (the
    # escalated attempt above dropped step 3, so the newest is step 2).
    from autodist_tpu_torch.telemetry import recorder
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["AUTODIST_RECORDER"] = "1"
        os.environ["AUTODIST_RECORDER_DIR"] = tmp
        try:
            recorder.set_recorder(None)
            assert recovery.rollback(signal, ring, attempt=1, max_attempts=2)["w"][0] == 2.0
            assert any("recover.rollback.s2" in d for d in os.listdir(tmp))
        finally:
            recorder.set_recorder(None)
            del os.environ["AUTODIST_RECORDER"], os.environ["AUTODIST_RECORDER_DIR"]
    points = faults.parse("worker_crash@step=3,worker=1;wire_reset@op=read,count=2")
    assert [(p.kind, p.step, p.worker, p.op, p.count) for p in points] == \
        [("worker_crash", 3, 1, None, 1), ("wire_reset", None, None, "read", 2)]
    faults.install(points)
    try:
        assert not faults.should_fire("worker_crash", step=2, worker=1)
        assert faults.should_fire("worker_crash", step=3, worker=1)
        assert not faults.should_fire("worker_crash", step=3, worker=1)
        assert [faults.should_fire("wire_reset", op="read") for _ in range(3)] == \
            [True, True, False]
    finally:
        faults.clear()
    with pytest.raises(ValueError):
        faults.parse("worker_crash@bogus=1")
    batch = {"x": np.ones((4, 2), np.float32), "ids": np.arange(4)}
    bad = faults.corrupt_batch(batch)
    assert torch.isnan(bad["x"]).all() and torch.equal(bad["ids"], torch.arange(4))
    faults.install("nan_grads@step=1")
    try:
        state = train(_linear_runner(), {"w": torch.zeros(2)},
                      lambda i: {"x": np.ones((4, 2), np.float32)}, steps=2, log_every=0)
    finally:
        faults.clear()
    assert torch.isnan(state.params["w"]).all()


@pytest.mark.parametrize("builder", [PS(sync=False), PS(staleness=3), AllReduce(),
                                     Parallax(), PartitionedPS()],
                         ids=lambda b: type(b).__name__)
def test_strategy_round_trips_by_id(builder, tmp_path, monkeypatch):
    monkeypatch.setattr(const, "DEFAULT_SERIALIZATION_DIR", str(tmp_path))
    spec = ModelSpec({"emb": torch.zeros(16, 4), "w": torch.zeros(4, 4), "b": torch.zeros(4)},
                     sparse_names=["emb"])
    strategy = builder.build(spec, ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "gpus": [0, 1]}]}))
    path = strategy.serialize()
    assert path == os.path.join(str(tmp_path), strategy.id)
    back = Strategy.deserialize(strategy.id)
    assert back.to_dict() == strategy.to_dict() and back.id == strategy.id


def test_multihost_joins_from_the_coordinator_env_and_refuses_both(monkeypatch):
    """One process of a multi-node spec reads the coordinator's env; with
    torchrun's set as well it raises; a lone process makes no group."""
    monkeypatch.setenv("AUTODIST_COORDINATOR_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("AUTODIST_NUM_PROCESSES", "2")
    monkeypatch.setenv("AUTODIST_PROCESS_ID", "1")
    assert multihost._coordinator_env(None) == ("127.0.0.1:1", 2, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="both torchrun"):
        multihost.maybe_initialize_multihost(torch.device("cpu"))
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("AUTODIST_NUM_PROCESSES", "1")
    assert not multihost.maybe_initialize_multihost(torch.device("cpu"))


def test_two_node_loopback_runs_across_processes(tmp_path):
    """Two processes from a two-node loopback spec, launched by the chief's
    Coordinator. Async: the port's ``async_ps_train`` on the host, both
    stepping over the transport, every step of both applied. Synchronous:
    ``tests/torch_two_node_script.py`` under ``AllReduce``, both ranks
    joining one gloo group at the coordinator's address, their losses and
    parameters equal to one process on the whole batch (rtol 1e-6)."""
    env = dict(os.environ, AUTODIST_WORKING_DIR=str(tmp_path / "wd"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out, steps = tmp_path / "summary.json", 4
    proc = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.examples.async_ps_train", "--device", "cpu",
         "--steps", str(steps), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(out.read_text())
    assert summary["applied_updates"] == 2 * steps
    assert summary["worker_steps"] == steps and summary["worker_wire_received_bytes"] > 0
    assert "[worker] step 3" in proc.stdout and "async PS summary" in proc.stdout

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        env["AUTODIST_COORDINATOR_PORT"] = str(s.getsockname()[1])
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_two_node_script.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = sorted((json.loads(line) for line in proc.stdout.splitlines()
                    if line.startswith("{")), key=lambda r: r["rank"])
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    from tests import torch_two_node_script as script
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce(), device="cpu")
    step = ad.function(script.loss_fn, {"w": torch.zeros(4, 1)},
                       lambda p: torch.optim.SGD(p, lr=0.1))
    losses = [float(step(script.batch())) for _ in range(3)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(r["w"], step.get_state().params["w"].flatten().tolist(),
                                   rtol=1e-6)
