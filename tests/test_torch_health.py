"""The port's training-health plane (autodist_tpu_torch.telemetry.health and
train()'s recover ring) against the JAX package's, on the CPU.

- The bundle: ``device_bundle`` and ``reduce_bundle`` on the same f32
  grads, update and params equal JAX's at rtol 1e-5, with a NaN leaf, and
  with a 1e20 leaf whose squared norm overflows f32 (both count it
  non-finite).
- ``HealthMonitor`` gives JAX's anomalies on the same loss series.
- Two gloo ranks under ZeRO (the update and its gradient sharded): the
  global norms equal the one-rank run's (rtol 1e-5).
- Health off adds nothing to a step: with every other plane armed, a
  steady ``run()`` dispatches the same ATen ops as with every plane off,
  each of them an op of the plain step (loss, backward, ``Adam.step``).
- ``AUTODIST_HEALTH_ACTION=recover``: a NaN batch at one step rolls back to
  the ring's snapshot, and the run finishes equal to one that never saw it,
  per step and under ``unroll=2``.
"""

import collections
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist, telemetry
from autodist_tpu_torch.telemetry import health, profiling
from autodist_tpu_torch.training import train
from test_torch_ring_attention import join_gloo_group, ranks_running

ONE = {"nodes": [{"address": "localhost", "gpus": [0]}]}
TWO = {"nodes": [{"address": "localhost", "gpus": [0, 1]}]}
RTOL = 1e-5


def _trees(case):
    rng = np.random.RandomState(3)
    grads = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    updates = {k: (1e-3 * v).astype(np.float32) for k, v in grads.items()}
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32),
              "step": np.arange(4, dtype=np.int32)}
    if case == "nan":
        grads["b"][2] = np.nan
    elif case == "overflow":
        params["a"][0, 0] = 1e20
    return grads, updates, params, np.float32(1.25)


@pytest.mark.parametrize("case", ["finite", "nan", "overflow"])
def test_bundle_and_reduction_match_jax(case):
    """device_bundle on the same trees, and reduce_bundle on a [3, 4] stack
    of them, equal the JAX package's (rtol 1e-5; non-finite entries equal as
    NaN/Inf)."""
    import jax
    from autodist_tpu.telemetry import health as jax_health
    grads, updates, params, loss = _trees(case)
    want = np.asarray(jax.device_get(jax_health.device_bundle(grads, updates, params, loss)))
    got = health.device_bundle({k: torch.from_numpy(v) for k, v in grads.items()},
                               {k: torch.from_numpy(v) for k, v in updates.items()},
                               {k: torch.from_numpy(v) for k, v in params.items()},
                               torch.tensor(loss)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0] == {"finite": 0, "nan": 1, "overflow": 1}[case]
    stack = np.stack([want, want * 2, want / 2]).astype(np.float32)
    np.testing.assert_allclose(health.reduce_bundle(torch.from_numpy(stack)).numpy(),
                               np.asarray(jax_health.reduce_bundle(stack)), rtol=RTOL)


def test_monitor_anomalies_match_jax():
    """The same loss series (a warm-up, a spike, a NaN) and bundles give the
    same anomaly records, in order."""
    from autodist_tpu.telemetry import health as jax_health
    rng = np.random.RandomState(5)
    series = [1.0 + 0.01 * rng.randn(4) for _ in range(5)]
    series[3][2] = 9.0
    series[4][1] = np.nan
    bundles = [np.array([0, 1.0, 1e-3, 10.0], np.float32)] * 4 \
        + [np.array([1, np.nan, 1e-3, 10.0], np.float32)]
    found = []
    for mod in (jax_health, health):
        mon = mod.HealthMonitor(mod.HealthConfig(action="warn", z_max=6.0))
        found.append([mon.observe(4 * (i + 1), losses, b)
                      for i, (losses, b) in enumerate(zip(series, bundles))])
    assert repr(found[0]) == repr(found[1])
    assert [a["kind"] for period in found[1] for a in period] == ["loss_spike", "nonfinite"]


# ----------------------------------------------------------- two ranks, ZeRO

def _loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _params():
    rng = np.random.RandomState(1)
    return {"w": torch.tensor(rng.randn(8, 4).astype(np.float32)),
            "b": torch.zeros(4)}


def _batch(i):
    rng = np.random.RandomState(40 + i)
    x = rng.randn(16, 8).astype(np.float32)
    return {"x": x, "y": (x[:, :4] * 0.5).astype(np.float32)}


def _zero_bundle(resources):
    """The health bundle after two steps of Adam under ZeRO."""
    ad = AutoDist(resource_info=resources, strategy_builder=AllReduce(), device="cpu")
    runner = ad.create_distributed_session(_loss, _params(),
                                           lambda p: torch.optim.Adam(p, lr=1e-2), zero=1,
                                           health=True)
    state = runner.init(_params())
    for i in range(2):
        runner.run(state, _batch(i))
    sharded = [k for k, pl in runner.layout.by_key.items() if pl.sharded_update]
    return runner.last_health.numpy(), sharded


def _rank_main(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    bundle, sharded = _zero_bundle(TWO)
    if dist.get_rank() == 0:
        np.savez(workdir / "zero_bundle.npz", bundle=bundle, sharded=np.array(sharded))
    dist.destroy_process_group()


def test_two_rank_zero_norms_equal_one_rank(tmp_path):
    """Under ZeRO over two gloo ranks each rank holds half of the update and
    gradient of ``w`` and of ``b``; the bundle's norms, summed over the
    mesh, equal the one-rank run's."""
    with ranks_running(pathlib.Path(__file__), 2, "zero", tmp_path) as wait:
        one, _ = _zero_bundle(ONE)
        wait()
    got = np.load(tmp_path / "zero_bundle.npz")
    assert sorted(got["sharded"]) == ["b", "w"]
    np.testing.assert_allclose(got["bundle"], one, rtol=RTOL)


# ------------------------------------------------------------ health off

class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ATen ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _step_ops(health_on, armed):
    """The ops of a steady ``run()`` (the second; the first builds)."""
    if armed:
        telemetry.enable()
        profiling.enable()
    try:
        ad = AutoDist(resource_info=ONE, strategy_builder=AllReduce(), device="cpu")
        runner = ad.create_distributed_session(_loss, _params(),
                                               lambda p: torch.optim.Adam(p, lr=1e-2),
                                               health=health_on)
        state = runner.init(_params())
        runner.run(state, _batch(0))
        with _Ops() as counted:
            runner.run(state, _batch(1))
    finally:
        telemetry.disable()
        telemetry.clear()
        profiling.disable()
        profiling.reset()
    return counted.ops


def test_health_off_adds_no_op_to_a_step():
    off = _step_ops(False, armed=False)
    assert _step_ops(False, armed=True) == off
    params = {k: v.requires_grad_() for k, v in _params().items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2)
    batch = {k: torch.as_tensor(v) for k, v in _batch(1).items()}
    with _Ops() as plain:
        _loss(params, batch).backward()
        optimizer.step()
    assert off - plain.ops == collections.Counter()
    assert sum((_step_ops(True, armed=False) - off).values()) > 0   # the bundle's ops


# ------------------------------------------------------------------ recover

def _poisoned(at):
    """``_batch``, with NaN inputs the first time step ``at`` is pulled (a
    replay after the rollback gets the clean batch)."""
    fired = []

    def batch(i):
        b = _batch(i)
        if i == at and not fired:
            fired.append(i)
            b["x"] = np.full_like(b["x"], np.nan)
        return b
    return batch


@pytest.mark.parametrize("unroll", [1, 2])
def test_recover_rolls_back_and_finishes_equal_to_a_clean_run(unroll, monkeypatch):
    monkeypatch.setenv("AUTODIST_HEALTH_ACTION", "recover")

    def run(batches):
        ad = AutoDist(resource_info=ONE, strategy_builder=AllReduce(), device="cpu")
        runner = ad.create_distributed_session(_loss, _params(),
                                               lambda p: torch.optim.Adam(p, lr=1e-2),
                                               health=True)
        monitor = telemetry.HealthMonitor()
        state = train(runner, _params(), batches, steps=8, log_every=2, unroll=unroll,
                      health_monitor=monitor)
        return state, monitor

    clean, mon = run(_batch)
    assert mon.anomalies == []
    healed, mon = run(_poisoned(4))
    assert healed.step == 8 and [a["kind"] for a in mon.anomalies] == ["nonfinite"]
    for k in clean.params:
        assert torch.equal(healed.params[k], clean.params[k]), k
    assert math.isfinite(float(healed.params["w"].detach().sum()))


if __name__ == "__main__":
    if sys.argv[1] == "zero":
        _rank_main(pathlib.Path(sys.argv[2]))
