"""The port's async PS plane (autodist_tpu_torch.parallel.staleness) against
the JAX package's, on the small TransformerLM (2 layers, d 64, vocab 128,
f32) whose weights the port's converter carries from the JAX model: the
staleness gate on scripted sequences (exact), one worker's steps and a
stale interleaving (losses rtol 1e-4, params atol 1e-5 after 3 Adam steps,
the port's f32 parity tolerance), the sharded apply (bit for bit), what
raises, and train() with checkpoints (bit for bit on the host)."""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, from_jax_params
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import staleness
from autodist_tpu_torch.parallel.plan import COMP_BF16, ShardingPlan
from autodist_tpu_torch.strategy import PS
from autodist_tpu_torch.testing import faults
from autodist_tpu_torch.training import train

SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32)
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
BATCH, SEQ, LR = 16, 16, 1e-3
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5


def _config(module):
    return module.TransformerLMConfig(**SMALL, dtype=np.float32 if module is not tlm
                                      else torch.float32, tied_output=False, fused_head=True)


@functools.cache
def _jax_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    return jax.device_get(jlm.init_params(_config(jlm), jax.random.PRNGKey(3))[1])


def _batch(i):
    rng = np.random.RandomState(200 + i)
    return {"tokens": rng.randint(0, SMALL["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)}


def _port(builder=None, **kwargs):
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=builder or PS(sync=False),
                  device="cpu")
    return ad.create_distributed_session(
        tlm.make_loss_fn(tlm.TransformerLM(_config(tlm))), from_jax_params(_jax_params()),
        lambda p: torch.optim.Adam(p, lr=LR, eps=1e-8), **kwargs)


def _jax(**kwargs):
    import optax
    from autodist_tpu import AutoDist as JaxAutoDist
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.strategy import PS as JaxPS
    ad = JaxAutoDist("nodes: [{address: localhost, gpus: [0]}]", JaxPS(sync=False))
    return ad.create_distributed_session(jlm.make_loss_fn(jlm.TransformerLM(_config(jlm))),
                                         _jax_params(), optax.adam(LR), **kwargs)


def _close(port_params, jax_params):
    import jax
    want = from_jax_params(jax.device_get(jax_params))
    assert sorted(port_params) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(port_params[k].detach(), v, rtol=0, atol=PARAM_ATOL)


def _script(mod):
    """One scripted walk of a gate: each call's result or exception name."""
    c = mod.StalenessController(2, staleness=1)
    out = []

    def do(name, *args):
        try:
            out.append((name, args, getattr(c, name)(*args)))
        except Exception as e:  # noqa: BLE001 — the exception's type is the result
            out.append((name, args, type(e).__name__))

    for name, *args in [
            ("start_step", 0, 0.01), ("finish_step", 0), ("start_step", 0, 0.01),
            ("start_step", 1, 0.01), ("finish_step", 1), ("start_step", 0, 0.01),
            ("finish_step", 0), ("retire", 1), ("retire", 1), ("start_step", 1, 0.01),
            ("start_step", 0, 0.01), ("finish_step", 0), ("register", 1), ("register", 1),
            ("retire", 1, 1), ("generation", 1), ("register", None), ("register", 9000),
            ("register", -1), ("slot_state", 2), ("slot_state", 7), ("live_lags",),
            ("retire", 0), ("start_step", 1, 0.01), ("register_with_generation", 0)]:
        do(name, *args)
    out.append(("steps", c.steps, c.bound))
    out.append(("histograms", {w: {k: v for k, v in h.items()}
                               for w, h in c.staleness_snapshot().items()}))
    return out


def test_staleness_controller_scripts_match_jax():
    """Lags, generations, slot states, timeouts and evictions, step for step."""
    from autodist_tpu.parallel import staleness as jax_staleness
    assert _script(staleness) == _script(jax_staleness)


def test_one_worker_matches_jax_async_runner():
    """PS(sync=False), one worker, 3 Adam steps through ``run``: the losses
    and the service's params match the JAX package's ``AsyncPSRunner``."""
    runner, jrunner = _port(), _jax()
    assert isinstance(runner, staleness.AsyncPSRunner)
    assert type(jrunner).__name__ == "AsyncPSRunner"
    state, jstate = runner.init(from_jax_params(_jax_params())), jrunner.init(_jax_params())
    losses, jlosses = [], []
    for i in range(3):
        state, loss = runner.run(state, _batch(i))
        jstate, jloss = jrunner.run(jstate, _batch(i))
        losses.append(float(loss))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert runner.service.updates_applied == jrunner.service.updates_applied == 3
    _close(runner.service.state.params, jrunner.service.state.params)


def _interleave(read, grad, apply):
    """Workers 0 and 1 read version 0; worker 0 applies; worker 1 then
    computes on the version it read and applies (a stale gradient)."""
    p0, p1 = read(), read()
    apply(grad(p0, _batch(0)))
    apply(grad(p1, _batch(1)))


def test_stale_interleaving_computes_on_the_version_read():
    """The stale script gives JAX's parameters; the version worker 1 held is
    unchanged after worker 0's apply; and a service that let worker 1 see the
    new version would be told apart (its result is farther off than the
    tolerance)."""
    import jax
    runner, jrunner = _port(num_workers=2), _jax(num_workers=2)
    runner.init(from_jax_params(_jax_params()))
    jrunner.init(_jax_params())

    def jgrad(params, batch):
        with jrunner.mesh:
            out = jrunner.grad_fn(params[0], jrunner.shard_batch(batch), params[1])
            return jax.block_until_ready(out[0])

    _interleave(lambda: jrunner.service.read()[:2], jgrad, jrunner.service.apply)
    held = {}

    def read():
        params, ef, _ = runner.service.read()
        held.setdefault("v0", (params, {k: v.detach().clone() for k, v in params.items()}))
        return params, ef

    def grad(params, batch):
        return runner.grad_fn(params[0], runner.shard_batch(batch), params[1])[0]

    _interleave(read, grad, runner.service.apply)
    assert runner.service.version == 2
    for k, v in held["v0"][1].items():
        assert torch.equal(held["v0"][0][k], v), k
    _close(runner.service.state.params, jrunner.service.state.params)

    fresh = _port(num_workers=2)
    fresh.init(from_jax_params(_jax_params()))
    for i in range(2):
        params, ef, _ = fresh.service.read()
        fresh.service.apply(grad((params, ef), _batch(i)))
    gap = max(float((fresh.service.state.params[k] - runner.service.state.params[k])
                    .detach().abs().max()) for k in runner.service.state.params)
    assert gap > 10 * PARAM_ATOL


@pytest.mark.parametrize("zero,shards", [(1, staleness.DEFAULT_PS_SHARDS), (2, 2)])
def test_sharded_apply_equals_the_unsharded_service(zero, shards):
    """``zero=2`` splits the apply over two shards, ``zero=1`` over the
    default count; 3 steps equal the unsharded service's bit for bit, and
    the assembled state carries every parameter's Adam moments."""
    runs = {}
    for z in (0, zero):
        runner = _port(zero=z)
        state = runner.init(from_jax_params(_jax_params()))
        for i in range(3):
            state, _ = runner.run(state, _batch(i))
        runs[z] = runner
    sharded = runs[zero].service
    assert isinstance(sharded, staleness.ShardedParameterService) and sharded.shards == shards
    assert sharded.shard_versions == [3] * shards
    for k, v in runs[0].service.state.params.items():
        assert torch.equal(sharded.state.params[k], v), k
    merged = sharded.state.optimizer
    for t in sharded.state.opt_params.values():
        assert torch.equal(merged.state[t]["exp_avg"],
                           runs[0].service.state.optimizer.state[
                               runs[0].service.state.opt_params[
                                   next(k for k, u in sharded.state.opt_params.items()
                                        if u is t)]]["exp_avg"])


def test_what_the_async_regime_refuses(monkeypatch):
    """As in JAX: accumulation_steps > 1 and a gradient codec raise before
    any step, run_many raises, a worker process's evaluate raises, and
    ``AutoDist.function`` gives an async plan no ``evaluate``."""
    with pytest.raises(ValueError, match="accumulation_steps"):
        _port(accumulation_steps=2)
    with pytest.raises(ValueError, match="accumulation_steps"):
        _jax(accumulation_steps=2)
    runner = _port()
    plan = ShardingPlan(runner.plan.mesh_axes, {
        n: dataclasses.replace(p, compressor=COMP_BF16) for n, p in runner.plan.params.items()})
    with pytest.raises(NotImplementedError, match="compression"):
        staleness.AsyncPSRunner(None, runner._model_spec, runner._loss_fn, runner._optimizer,
                                torch.device("cpu"), plan=plan)
    with pytest.raises(RuntimeError, match="run_many"):
        runner.run_many(None, [_batch(0)])
    worker = _port()
    monkeypatch.setenv("AUTODIST_WORKER", "127.0.0.1")
    worker._ps_address = "127.0.0.1:1"
    state = worker.init(from_jax_params(_jax_params()))
    assert worker.service is None
    with pytest.raises(RuntimeError, match="not available on async worker"):
        worker.evaluate(state, _batch(0))
    monkeypatch.delenv("AUTODIST_WORKER")
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=PS(staleness=1), device="cpu")
    step = ad.function(lambda p, b: (p["w"] * b["x"]).sum(), {"w": torch.ones(2)},
                       lambda p: torch.optim.SGD(p, lr=0.1))
    assert not hasattr(step, "evaluate")
    assert float(step({"x": np.ones(2, np.float32)})) == 2.0


def test_two_workers_under_staleness_two_with_a_crash_and_rejoin():
    """Two in-process workers, PS(staleness=2), from two threads: every step
    applies, no gate entry finds a lag above 2. Then a ``worker_crash``
    fault retires worker 1 at its step 2; ``add_worker`` re-admits the slot
    seeded at the slowest live count and the run finishes finite."""
    runner = _port(PS(staleness=2), num_workers=2)
    runner.init(from_jax_params(_jax_params()))
    errors = []

    def drive(wid, steps):
        try:
            for i in range(steps):
                runner.worker(wid).step(_batch(wid * 10 + i), timeout=60.0)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((wid, e))

    threads = [threading.Thread(target=drive, args=(w, 4)) for w in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors and runner.service.updates_applied == 8
    assert runner.controller.max_lag() <= 2
    faults.install("worker_crash@step=4,worker=1")
    try:
        with pytest.raises(faults.WorkerCrashed):
            runner.worker(1).step(_batch(50))
        assert runner.controller.slot_state(1) == "retired"
        runner.worker(0).step(_batch(51))
        handle = runner.add_worker(1)
        assert runner.controller.steps[1] == runner.controller.steps[0]
        handle.step(_batch(52))
    finally:
        faults.clear()
    assert runner.service.updates_applied == 10
    assert all(torch.isfinite(v).all() for v in runner.service.state.params.values())


def test_train_runs_saves_and_resumes(tmp_path):
    """train() under PS(sync=False): 4 steps saving every 2, then a resumed
    run to 6 equals an uninterrupted 6-step run bit for bit (unroll=2 falls
    back to per-step dispatch)."""
    whole = train(_port(), from_jax_params(_jax_params()), _batch, steps=6, log_every=0)
    ckpt = str(tmp_path / "ckpt")
    first = train(_port(), from_jax_params(_jax_params()), _batch, steps=4,
                  checkpoint_dir=ckpt, save_every=2, log_every=0, unroll=2)
    assert first.step == 4
    resumed_runner = _port()
    resumed = train(resumed_runner, from_jax_params(_jax_params()), _batch, steps=6,
                    checkpoint_dir=ckpt, save_every=2, log_every=0)
    assert resumed.step == 6 and resumed_runner.service.updates_applied == 2
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v), k
