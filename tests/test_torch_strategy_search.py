"""The port's strategy search against the JAX package's, on the same inputs:
``AutoStrategy``'s strategy per parameter in each regime,
``choose_optimizer``'s decision, the cost model's ``calibrate`` and
``predict`` (rel 1e-12), ``enumerate_candidates``' names, order and
pre-flight refusals, ``train()``'s block boundaries, the plan cache's file
(one the JAX package wrote is read through the same schema, and its keys
never match the port's), and a tiny TransformerLM's ``train(unroll=4)``
against the JAX package's (losses rtol 1e-4, params atol 1e-5, the
tolerances of ``tests/test_torch_training.py``). Then the search's own
contracts: ``tune_strategy``'s failure-skip, ``probed <= top_k``, and a
stored plan applied again with no search. (Mirrors
``tests/test_auto_strategy.py``, ``tests/test_tuner.py`` and
``tests/test_autotune.py``.)"""

import importlib
import json

import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from autodist_tpu_torch import AllReduce, AutoDist, PSLoadBalancing, from_jax_params
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.optimizers import Adafactor
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import auto_strategy as tauto
from autodist_tpu_torch.telemetry import costmodel as tcost

# The modules (each package exports a function of the same name).
ttune = importlib.import_module("autodist_tpu_torch.strategy.autotune")


def _jtune():
    return importlib.import_module("autodist_tpu.strategy.autotune")


SHAPES = {"emb": (12, 4), "w1": (7, 3), "w2": (4, 4), "b": (3,), "s": ()}
ONE = {"nodes": [{"address": "localhost", "gpus": [0]}]}
EIGHT = {"nodes": [{"address": "localhost", "tpus": 8}]}


def _multi_node(bandwidth):
    extra = {} if bandwidth is None else {"network_bandwidth": bandwidth}
    return {"nodes": [{"address": "10.0.0.1", "tpus": 4, "chief": True, **extra},
                      {"address": "10.0.0.2", "tpus": 4, **extra}]}


def _specs(sparse: bool, shapes=SHAPES):
    import jax.numpy as jnp
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    names = ["emb"] if sparse else []
    return (JModelSpec({k: jnp.zeros(s) for k, s in shapes.items()}, sparse_names=names),
            ModelSpec({k: torch.zeros(s) for k, s in shapes.items()}, sparse_names=names))


def _adam(p):
    return torch.optim.Adam(p, lr=1e-3)


# name: (resources, sparse, AutoStrategy keywords)
REGIMES = {
    "fits": (EIGHT, False, dict(memory_budget_bytes=1 << 20)),
    "memory-bound": (EIGHT, False, dict(memory_budget_bytes=300)),
    "sparse": (EIGHT, True, dict(memory_budget_bytes=1 << 20)),
    "sparse-memory-bound": (EIGHT, True, dict(memory_budget_bytes=200)),
    "partitioned": (EIGHT, False, dict(memory_budget_bytes=1 << 20,
                                       partition_threshold_bytes=40)),
    "partitioned-memory-bound": (EIGHT, True, dict(memory_budget_bytes=300,
                                                   partition_threshold_bytes=40)),
    "multi-node-unstated": (_multi_node(None), False, dict(memory_budget_bytes=1 << 20)),
    "multi-node-fast": (_multi_node(400), False, dict(memory_budget_bytes=1 << 20)),
    "multi-node-bf16": (_multi_node(50), False, dict(memory_budget_bytes=1 << 20)),
    "multi-node-ef": (_multi_node(10), True, dict(memory_budget_bytes=1 << 20)),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_auto_strategy_matches_jax_per_variable(regime):
    """The built strategy, node by node (synchronizer, destination, group,
    spec, codec, partitions, sparse flag) and its mesh, with the optimizer's
    state bytes (optax.adam's from eval_shape; torch's Adam's from meta
    tensors) and an explicit memory budget."""
    import optax
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import AutoStrategy as JAutoStrategy

    resources, sparse, kw = REGIMES[regime]
    jspec, tspec = _specs(sparse)
    jbuilder = JAutoStrategy(optimizer=optax.adam(1e-3), **kw)
    tbuilder = tstrategy.AutoStrategy(**kw)
    tbuilder.observe_optimizer(_adam)
    want = MessageToDict(jbuilder.build(jspec, JResourceSpec(resource_info=resources)).proto,
                         preserving_proto_field_name=True)
    got = tbuilder.build(tspec, ResourceSpec(resource_info=resources)).to_dict()
    want.pop("id"), got.pop("id")
    assert got == want
    regime_row = dict(tbuilder._decisions)["<regime>"]
    assert ("PS/ZeRO" in regime_row) == ("memory-bound" in regime)
    assert "built on meta tensors" in regime_row


def test_auto_strategy_without_optimizer_state_says_so():
    """No optimizer, or one that builds no state on meta tensors: the
    Adam-class 3x assumption, as the JAX package's with none, said in
    explain()."""
    _, tspec = _specs(False)
    for optimizer, why in ((None, "pass the optimizer"),
                           (lambda p: (_ for _ in ()).throw(TypeError("no meta")),
                            "does not build its state on meta tensors")):
        builder = tstrategy.AutoStrategy(memory_budget_bytes=1 << 20, optimizer=optimizer)
        builder.build(tspec, ResourceSpec(resource_info=EIGHT))
        assert "3x params" in builder.explain() and why in builder.explain()


def test_choose_optimizer_matches_jax():
    from autodist_tpu.strategy.auto_strategy import choose_optimizer as jchoose
    params = {"emb": np.zeros((4096, 256), np.float32)}       # 4 MiB
    for budget in (10 << 20, 15 << 20, 17 << 20, 64 << 20):
        want = jchoose(params, memory_budget_bytes=budget)
        got = tauto.choose_optimizer({"emb": torch.zeros(4096, 256)},
                                     memory_budget_bytes=budget)
        assert got.factored == want.factored, budget
        optimizer = got.optimizer([torch.zeros(4, 4, requires_grad=True)])
        # The factored choice is the port's optax.adafactor, not torch's Adafactor.
        assert isinstance(optimizer, Adafactor if got.factored else torch.optim.Adam)


# ------------------------------------------------------------------ cost model

RECORDS = [
    {"flops": 3.0e9, "bytes_accessed": 2.5e8, "steps": 1, "dispatches": 3,
     "temp_bytes": 7.0e6},
    {"flops": 1.2e10, "bytes_accessed": 9.0e8, "steps": 4, "dispatches": 1,
     "argument_bytes": 1.0e6, "output_bytes": 3.0e5},
    {"flops": None, "bytes_accessed": 4.0e7, "steps": None, "dispatches": None},
]
PROFILE = {
    "summary": {"shares": {"compute": 0.62, "comm": 0.11}, "wall_s": 12.5, "steps": 150,
                "flops_per_step": 2.2e9, "bytes_per_step": 3.1e8,
                "host_s_per_dispatch": 1.7e-4, "step_s": 0.0833},
    "wire": {"bytes_sent": 3.3e9, "bytes_received": 2.9e9, "bytes_quantized": 4.1e9,
             "quantize_s": 1.9},
    "programs": {"step": RECORDS[0], "block": RECORDS[1]},
}


def _close(got, want, path="predict"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), path
    else:
        assert got == want, path


def test_costmodel_matches_jax():
    """calibrate, predict (each term: device, host, wire, quantize, the
    loader's residual, peak memory) and predict_from_profile on the same
    records, rel 1e-12."""
    from autodist_tpu.telemetry import costmodel as jcost
    jcal, tcal = jcost.calibrate(PROFILE), tcost.calibrate(PROFILE)
    _close(tcal.to_dict(), jcal.to_dict())
    for kw in ({}, dict(comm_bytes_per_step=2.0e8), dict(loader_s_per_step=0.3),
               dict(loader_s_per_step=0.3, prefetch_depth=2),
               dict(quantize_bytes_per_step=5.0e8, resident_bytes=3.0e9)):
        for records in (RECORDS, RECORDS[1]):
            _close(tcost.predict(records, tcal, **kw), jcost.predict(records, jcal, **kw))
    _close(tcost.predict_from_profile(PROFILE), jcost.predict_from_profile(PROFILE))
    empty = tcost.predict({}, tcost.Calibration())
    assert empty["bound"] == "unknown" and empty["steps_per_s"] is None
    # The port's launches: an eager step's host term is its launches' sum.
    one = tcost.predict({"flops": 1e9, "launches": 70}, tcost.Calibration(1e12, 1e11, 1e-5))
    assert one["breakdown"]["host_s"] == pytest.approx(70e-5, rel=1e-12)


# ------------------------------------------------------------------ enumeration

def _big_specs(sparse: bool):
    """A 64 MiB parameter (the JAX package's fixed partition threshold),
    as shapes only."""
    import jax
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    shapes = {"big": (4096, 4096), "w": (8, 8), "emb": (16, 4)}
    names = ["emb"] if sparse else []
    jspec = JModelSpec({k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()},
                       sparse_names=names)
    tspec = ModelSpec({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                      sparse_names=names)
    return jspec, tspec


@pytest.mark.parametrize("case", ["one-dense", "eight-sparse", "eight-partitioned",
                                  "memory-bound-async", "loader-cost"])
def test_enumerate_candidates_matches_jax(case, monkeypatch):
    """Names, order, resident bytes and pre-flight refusals, under one
    memory budget (AUTODIST_MEM_BUDGET, read by both)."""
    import optax
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    jtune = _jtune()

    budget = {"memory-bound-async": 200 << 20}.get(case, 8 << 30)
    monkeypatch.setenv("AUTODIST_MEM_BUDGET", str(budget))
    resources = ONE if case == "one-dense" else EIGHT
    sparse = case != "one-dense"
    if case in ("eight-partitioned", "memory-bound-async"):
        jspec, tspec = _big_specs(sparse)
    else:
        jspec, tspec = _specs(sparse)
    kw = dict(accums=(1, 2)) if case == "one-dense" else {}
    if case == "loader-cost":
        kw = dict(loader_s_per_step=0.01, budget=9)
    want = jtune.enumerate_candidates(jspec, JResourceSpec(resource_info=resources),
                                      optax.adam(1e-3), **kw)
    got = ttune.enumerate_candidates(tspec, ResourceSpec(resource_info=resources), _adam,
                                     **kw)
    assert [c.name for c in got] == [c.name for c in want]
    assert [c.resident_bytes for c in got] == [c.resident_bytes for c in want]
    assert [c.pruned is not None for c in got] == [c.pruned is not None for c in want]
    assert [c.base_key() for c in got] == [c.base_key() for c in want]


def test_boundary_fn_matches_jax():
    from autodist_tpu.training import _boundary_fn as jboundary
    from autodist_tpu_torch.training import _boundary_fn as tboundary
    for steps, save, ev in ((10, 0, 0), (10, 3, 0), (17, 4, 6), (9, 0, 3), (5, 7, 2)):
        want, got = jboundary(steps, save, ev), tboundary(steps, save, ev)
        assert [got(i) for i in range(steps)] == [want(i) for i in range(steps)]


def test_plan_cache_file_from_jax_reads_through_the_same_schema(tmp_path):
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    jtune = _jtune()

    path = str(tmp_path / "plans.json")
    jspec, tspec = _specs(True)
    batch = {"x": np.zeros((8, 3), np.float32)}
    jkey = jtune.plan_cache_key(jspec, batch, JResourceSpec(resource_info=ONE))
    assert jtune.store_plan(path, jtune.TunedPlan(
        {"name": "Parallax"}, unroll=4, zero=1, prefetch_depth=2, cache_key=jkey,
        measured_steps_per_s=12.5, predicted={"step_s": 0.08, "bound": "host"}))
    doc = json.load(open(path))
    assert (doc["schema"], doc["schema_version"]) == (ttune.PLAN_SCHEMA,
                                                      ttune.PLAN_SCHEMA_VERSION)
    plan = ttune.load_cached_plan(path, jkey)
    assert plan.from_cache and (plan.name, plan.unroll, plan.zero) == (
        "Parallax[unroll=4,zero=1,pf=2]", 4, 1)
    assert isinstance(plan.make_builder(), tstrategy.Parallax)
    tkey = ttune.plan_cache_key(tspec, batch, ResourceSpec(resource_info=ONE))
    assert tkey != jkey and ttune.load_cached_plan(path, tkey) is None
    plan.cache_key = tkey
    assert ttune.store_plan(path, plan)
    again = jtune.load_cached_plan(path, tkey)      # the JAX package reads the port's entry
    assert again.name == plan.name
    assert jtune.load_cached_plan(path, jkey).name == plan.name


def test_train_unroll_matches_jax():
    """A tiny TransformerLM's train(unroll=4) over 8 steps (two blocks)
    against the JAX package's: each step's loss and the final params."""
    import jax
    import optax
    import autodist_tpu
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu.training import train as jtrain
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.training import train

    small = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=16)

    def config(module):
        return module.TransformerLMConfig(**small, dtype=np.float32 if module is jlm
                                          else torch.float32, tied_output=False,
                                          fused_head=True)

    def batch(i):
        rng = np.random.RandomState(300 + i)
        return {"tokens": rng.randint(0, 64, size=(8, 9)).astype(np.int32)}

    def recording(runner):
        runner.block_losses, run_many = [], runner.run_many

        def recorded(state, block, fetches=None):
            state, losses = run_many(state, block, fetches)
            runner.block_losses += [float(x) for x in np.asarray(losses)]
            return state, losses

        runner.run_many = recorded
        return runner

    jparams = jax.device_get(jlm.init_params(config(jlm), jax.random.PRNGKey(3))[1])
    jrunner = recording(autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE), JAllReduce())
                        .create_distributed_session(
        jlm.make_loss_fn(jlm.TransformerLM(config(jlm))), jparams, optax.adam(1e-3)))
    jstate = jtrain(jrunner, jparams, batch, steps=8, log_every=0, unroll=4)
    runner = recording(AutoDist(resource_info=ONE, strategy_builder=AllReduce(),
                                device="cpu").create_distributed_session(
        tlm.make_loss_fn(tlm.TransformerLM(config(tlm))), from_jax_params(jparams),
        lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8)))
    state = train(runner, from_jax_params(jparams), batch, steps=8, log_every=0, unroll=4)
    assert len(runner.block_losses) == len(jrunner.block_losses) == 8
    np.testing.assert_allclose(runner.block_losses, jrunner.block_losses, rtol=1e-4)
    for key, value in from_jax_params(jax.device_get(jrunner.logical_params(jstate))).items():
        np.testing.assert_allclose(state.params[key].detach().numpy(), value.numpy(),
                                   atol=1e-5, rtol=0, err_msg=key)


# --------------------------------------------------------- the search's contracts

def _linear():
    rng = np.random.RandomState(7)
    params = {"w": torch.tensor(rng.randn(4, 1).astype(np.float32)), "b": torch.zeros(1)}
    batch = {"x": rng.randn(32, 4).astype(np.float32), "y": rng.randn(32, 1).astype(np.float32)}
    return (lambda p, b: ((b["y"] - (b["x"] @ p["w"] + p["b"])) ** 2).mean()), params, batch


def test_tune_strategy_skips_failures_and_async():
    """A candidate that fails is recorded with its error, an async one as
    skipped (the JAX package's words), and the search goes on; all failing
    raises."""
    loss, params, batch = _linear()

    class Broken(tstrategy.StrategyBuilder):
        def build(self, model_spec, resource_spec):
            raise RuntimeError("no plan")

    result = tstrategy.tune_strategy(
        loss, params, lambda p: torch.optim.SGD(p, lr=0.1), batch, device="cpu",
        candidates=[Broken(), tstrategy.PS(sync=False), AllReduce()],
        warmup_steps=1, measure_steps=2)
    broken, asynchronous, fine = result.results
    assert broken.steps_per_sec is None and broken.error.startswith("RuntimeError: no plan")
    assert asynchronous.steps_per_sec is None and asynchronous.error.startswith(
        "skipped: async candidate")
    assert fine.steps_per_sec > 0 and isinstance(result.best, AllReduce)
    assert "FAILED" in result.report() and "SKIPPED" in result.report()
    with pytest.raises(RuntimeError, match="every candidate"):
        tstrategy.tune_strategy(loss, params, lambda p: torch.optim.SGD(p, lr=0.1), batch,
                                candidates=[Broken()], device="cpu")
    with pytest.raises(ValueError, match="multi-node"):
        tstrategy.tune_strategy(loss, params, None, batch,
                                resource_spec=ResourceSpec(resource_info=_multi_node(10)))


def test_autotune_probes_at_most_top_k_and_reapplies_a_stored_plan(tmp_path, monkeypatch):
    """The search measures at most top_k candidates; its plan is stored, and
    ``AutoDist(strategy_builder="autotune")`` on the same problem applies it
    from the cache with no search and no probe step; train() adopts its
    unroll."""
    from autodist_tpu_torch.training import train
    loss, params, batch = _linear()
    cache = str(tmp_path / "plans.json")
    plan = tstrategy.autotune(loss, params, _adam, batch, device="cpu", plan_cache=cache,
                              top_k=2, warmup_steps=1, measure_steps=2,
                              resource_spec=ResourceSpec(resource_info=ONE))
    assert plan.probed <= 2 < plan.enumerated and not plan.from_cache
    assert sum(c.probe is not None and c.probe.steps_per_sec is not None
               for c in plan.candidates) >= 1
    assert "<- winner" in plan.explain()

    def no_probe(*args, **kwargs):
        raise AssertionError("a cached plan must not probe")

    monkeypatch.setattr(ttune, "measure_candidate", no_probe)
    monkeypatch.setattr(ttune, "_probe_base_costs", no_probe)
    monkeypatch.setenv("AUTODIST_PLAN_CACHE", cache)
    ad = AutoDist(resource_info=ONE, strategy_builder="autotune", device="cpu")
    runner = ad.create_distributed_session(loss, params, _adam, example_batch=batch)
    assert runner.tuned_plan.from_cache and runner.tuned_plan.name == plan.name
    assert type(ad._strategy_builder).__name__ == plan.builder_spec["name"]
    assert "applied from plan cache" in runner.tuned_plan.explain()
    blocks = []
    run_many = runner.run_many
    runner.run_many = lambda s, b, f=None: (blocks.append(len(b)), run_many(s, b, f))[1]
    state = train(runner, params, lambda i: batch, steps=plan.unroll + 1, log_every=0)
    assert state.step == plan.unroll + 1
    assert blocks == ([plan.unroll, 1] if plan.unroll > 1 else [])


def test_failed_search_keeps_the_default_builder(monkeypatch):
    loss, params, batch = _linear()

    def failing(*args, **kwargs):
        raise RuntimeError("every stage-2 probe failed")

    monkeypatch.setattr(ttune, "autotune", failing)
    ad = AutoDist(resource_info=ONE, device="cpu")
    runner = ad.create_distributed_session(loss, params, _adam, example_batch=batch, tune=True)
    assert runner.tuned_plan is None and isinstance(ad._strategy_builder, PSLoadBalancing)
