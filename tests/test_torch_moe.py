"""The port's MoE LM and ``ExpertParallel`` (autodist_tpu_torch.models.moe,
strategy.expert_parallel_strategy) against the JAX package's.

Without a spawn: Switch routing, the MoE FFN, the whole loss and its
gradients at f32 with JAX's weights (``from_jax_params``), the fused head's
plain version against the logits head, the strategies, compiled strategies
and plans for 8 devices, the sparse flags of the walk, the bank init and the
errors. Then 4 gloo ranks, every case in one spawn (the pattern of
tests/test_torch_ulysses.py): ``AutoDist(ExpertParallel)`` on an expert 2 x
data 2 and an expert 4 mesh, each rank running this file as a script (torch
and the port only).

Tolerances at f32: losses rtol 1e-5 and gradients atol 1e-4, BERT's and
NCF's. Routing: the dispatch tensor bit for bit; combine and the aux loss at
rtol 1e-6, since torch's f32 ``exp`` and XLA's differ in the last bit (the
softmax, and the order of the aux's means).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, from_jax_params
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import moe
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from test_torch_ring_attention import join_gloo_group, ranks_running

RANKS = 4
TINY = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=32,
            n_experts=4, capacity_factor=2.0)
BATCH, SEQ = 8, 16
FOUR_GPUS = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=0, atol=1e-4)
ROUTE = dict(rtol=1e-6, atol=0)
EXPERT_CASES = (("expert2-data2", 2), ("expert4", 4))
# Adam (the optimizer whose state the Saver maps) with eps 1: its first
# update is close to LR * g, so comparing it is as well conditioned as SGD's.
LR, EPS = 0.1, 1.0


def _adam(params):
    return torch.optim.Adam(params, lr=LR, eps=EPS)


def _config(dtype=torch.float32, **kw) -> moe.MoETransformerLMConfig:
    return moe.MoETransformerLMConfig(**TINY, dtype=dtype, **kw)


def _tokens():
    rng = np.random.RandomState(4)
    return rng.randint(0, TINY["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


# ------------------------------------------------------------------ the ranks

def _worker(workdir: pathlib.Path):
    import torch.distributed as dist

    from autodist_tpu_torch.checkpoint.saver import Saver
    join_gloo_group()
    rank = dist.get_rank()
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    batch = {"tokens": torch.tensor(np.load(workdir / "tokens.npy"))}
    model = moe.MoETransformerLM(_config())
    results = {}
    for case, axis in EXPERT_CASES:
        seen = []
        base = moe.make_loss_fn(model)

        def loss_fn(p, b):
            seen.append({k: tuple(v.shape) for k, v in p.items() if "experts_" in k})
            return base(p, b)

        ad = AutoDist(resource_info=FOUR_GPUS, device="cpu",
                      strategy_builder=tstrategy.ExpertParallel(num_experts=4,
                                                                expert_axis_size=axis))
        step = ad.function(loss_fn, params, _adam, example_batch=batch)
        del seen[:]                      # the walk's trace at the logical shapes
        results[f"{case}-loss"] = step(batch).numpy()
        results[f"{case}-seen"] = np.array(sorted({s for call in seen for s in call.values()}))
        runner, state = step.runner, step.get_state()
        results[f"{case}-mesh"] = np.array(str(dict(runner.plan.mesh_axes)))
        results[f"{case}-coords"] = np.array([runner.mesh.coords["data"],
                                              runner.mesh.coords["expert"]])
        for key, t in state.params.items():
            results[f"{case}-storage-{key}"] = t.detach().numpy()
        for key, t in runner.logical_params(state).items():
            results[f"{case}-logical-{key}"] = t.detach().numpy()
        saver = Saver()
        prefix = saver.save(state, str(workdir / f"ckpt-{case}"))
        restored = saver.restore(prefix, runner=runner)
        results[f"{case}-restored"] = np.array(all(
            torch.equal(restored.params[k], t) for k, t in state.params.items()))
    np.savez(workdir / f"moe_rank{rank}.npz", **results)
    dist.destroy_process_group()


@functools.cache
def _jax():
    """JAX's model, weights (its own init) and its loss and gradients on the
    tokens: the one JAX compile of the file."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import moe as jmoe
    cfg = jmoe.MoETransformerLMConfig(**TINY, dtype=jnp.float32)
    jmodel, jparams = jmoe.init_params(cfg)
    loss, grads = jax.jit(jax.value_and_grad(jmoe.make_loss_fn(jmodel)))(
        jparams, {"tokens": _tokens()})
    return jmodel, jax.device_get(jparams), float(loss), from_jax_params(jax.device_get(grads))


@pytest.fixture(scope="module", autouse=True)
def expert_runs(tmp_path_factory):
    """The 4-rank run, started before the file's first test (the others run
    meanwhile); calling it waits for the ranks and returns their results,
    rank by rank."""
    workdir = tmp_path_factory.mktemp("moe")
    np.savez(workdir / "params.npz",
             **{k: v.numpy() for k, v in from_jax_params(_jax()[1]).items()})
    np.save(workdir / "tokens.npy", _tokens())
    with ranks_running(pathlib.Path(__file__), RANKS, "moe", workdir) as wait:

        @functools.cache
        def results():
            wait()
            return [dict(np.load(workdir / f"moe_rank{r}.npz")) for r in range(RANKS)]

        yield results


# ----------------------------------------------------------- without a spawn

@pytest.mark.parametrize("case", ["random", "overflow"])
def test_switch_route_matches_jax(case):
    """Dispatch bit for bit (the argmax, the per-row queue positions, the
    dropped overflow: tests/test_expert_parallel.py:54-60's all-to-expert-0
    logits at capacity 2), combine and the aux loss to the last bit."""
    import jax.numpy as jnp
    from autodist_tpu.models import moe as jmoe
    if case == "overflow":
        logits, capacity = np.zeros((2, 6, 4), np.float32), 2
        logits[:, :, 0] = 10.0
    else:
        logits, capacity = np.random.RandomState(0).randn(3, 32, 8).astype(np.float32), 5
    want = jmoe.switch_route(jnp.asarray(logits), capacity)
    got = moe.switch_route(torch.tensor(logits), capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **ROUTE)
    np.testing.assert_allclose(float(got[2]), float(want[2]), **ROUTE)
    if case == "overflow":
        np.testing.assert_array_equal(got[0].sum(dim=(2, 3))[0].numpy(), [1, 1, 0, 0, 0, 0])


def test_moe_ffn_matches_jax():
    """One MoE FFN (capacity 8 of 16 tokens a row over 4 experts: some drop)
    on the same input and weights, and its input gradient."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import moe as jmoe
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16).astype(np.float32)
    p = {"router": {"kernel": rng.randn(16, 4).astype(np.float32)},
         "experts_in": (rng.randn(4, 16, 32) * 0.2).astype(np.float32),
         "experts_out": (rng.randn(4, 32, 16) * 0.2).astype(np.float32)}
    jffn = jmoe.MoEFFN(jmoe.MoETransformerLMConfig(**TINY, dtype=jnp.float32))

    def jloss(x):
        y, aux = jffn.apply({"params": p}, x)
        return (y ** 2).sum() + aux, y

    (_, want), want_dx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    ffn = moe.MoEFFN(_config())
    xt = torch.tensor(x, requires_grad=True)
    y, aux = torch.func.functional_call(ffn, from_jax_params(p), (xt,))
    ((y ** 2).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **GRAD)


def test_moe_loss_and_grads_match_jax():
    """The whole MoE loss (next-token NLL + 0.01 aux) and every leaf's
    gradient, with JAX's weights."""
    _, jparams, want_loss, want_grads = _jax()
    params = {k: v.requires_grad_() for k, v in from_jax_params(jparams).items()}
    loss = moe.make_loss_fn(moe.MoETransformerLM(_config()))(
        params, {"tokens": torch.tensor(_tokens())})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS)
    assert sorted(grads) == sorted(want_grads)
    for key, g in want_grads.items():
        np.testing.assert_allclose(grads[key].numpy(), g.numpy(), err_msg=key, **GRAD)


def test_fused_head_plain_version_matches_logits_head():
    """``fused_head=True`` (its kernels' plain versions on the host) equals
    the logits head, aux term included (tests/test_expert_parallel.py:73-83)."""
    params = from_jax_params(_jax()[1])
    batch = {"tokens": torch.tensor(_tokens())}
    plain = moe.make_loss_fn(moe.MoETransformerLM(_config()))(params, batch)
    fused = moe.make_loss_fn(moe.MoETransformerLM(_config(fused_head=True)))(params, batch)
    np.testing.assert_allclose(float(fused), float(plain), **LOSS)


@pytest.mark.parametrize("axis,mesh", [(2, None), (-1, None), (2, {"expert": 2, "data": 2,
                                                                   "reduce": 2})])
def test_expert_parallel_builds_compiles_and_plans_as_jax(axis, mesh):
    """8 devices: the built and compiled strategies field by field and the
    plan's specs (``expert_axis_size`` 2, -1 = 4, and a resource-spec mesh)."""
    from google.protobuf.json_format import MessageToDict

    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.parallel.plan import ShardingPlan as JPlan
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    info = {"nodes": [{"address": "localhost", "tpus": 8}], **({"mesh": mesh} if mesh else {})}
    jparams = _jax()[1]
    jspec, tspec = JModelSpec.from_params(jparams), ModelSpec(from_jax_params(jparams))
    jres, tres = JResourceSpec(resource_info=info), ResourceSpec(resource_info=info)
    jbuilt = jstrategy.ExpertParallel(num_experts=4, expert_axis_size=axis).build(jspec, jres)
    tbuilt = tstrategy.ExpertParallel(num_experts=4, expert_axis_size=axis).build(tspec, tres)
    jcompiled = jstrategy.StrategyCompiler(jspec, jres).compile(jbuilt)
    tcompiled = tstrategy.StrategyCompiler(tspec, tres).compile(tbuilt)
    for want, got in ((jbuilt, tbuilt), (jcompiled, tcompiled)):
        want = MessageToDict(want.proto, preserving_proto_field_name=True)
        got = got.to_dict()
        want.pop("id"), got.pop("id")
        assert got == want
    jplan = JPlan.from_strategy(jcompiled, jspec)
    tplan = ShardingPlan.from_strategy(tcompiled, tspec)
    assert dict(tplan.mesh_axes) == dict(jplan.mesh_axes)
    assert tplan.mesh_axes["expert"] == (2 if axis == 2 else 4)
    for name, jp in jplan.params.items():
        tp = tplan.params[name]
        assert (tp.pspec, tp.opt_pspec, tp.partition_mesh_axis, tp.num_shards) == (
            tuple(jp.pspec), tuple(jp.opt_pspec), jp.partition_mesh_axis, jp.num_shards), name
    assert sum(p.pspec[:1] == ("expert",) for p in tplan.params.values()) == 2 * TINY["n_layers"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_flags_match_jax(dtype):
    """The walk marks what JAX's marks: ``embed/embedding`` and ``pos_embed``
    at f32, ``pos_embed`` alone at bf16 (the table is cast before the
    gather); the expert collectives do nothing there (no mesh)."""
    import jax.numpy as jnp
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.models import moe as jmoe
    jparams, batch = _jax()[1], {"tokens": _tokens()}
    jmodel = jmoe.MoETransformerLM(jmoe.MoETransformerLMConfig(**TINY,
                                                              dtype=getattr(jnp, dtype)))
    want = JModelSpec.from_loss_fn(jmoe.make_loss_fn(jmodel), jparams, batch)
    model = moe.MoETransformerLM(_config(getattr(torch, dtype)))
    got = ModelSpec.from_loss_fn(moe.make_loss_fn(model), from_jax_params(jparams), batch)
    assert sorted(n for n, p in got.params.items() if p.sparse) == \
        sorted(n for n, p in want.params.items() if p.sparse)


def test_init_draws_the_banks_with_flax_fan_in():
    """The port's own init: the banks' lecun_normal counts the expert axis as
    receptive field (std 1/sqrt(E m)), the router's fan-in is m."""
    cfg = moe.MoETransformerLMConfig(vocab_size=64, d_model=64, n_heads=2, n_layers=1,
                                     d_ff=128, max_len=32, n_experts=8, dtype=torch.float32)
    _, params = moe.init_params(cfg, seed=3, device="cpu")
    for key, fan_in in (("block_0.moe.experts_in", 8 * 64), ("block_0.moe.experts_out", 8 * 128),
                        ("block_0.moe.router.kernel", 64)):
        # Four standard errors of a sample std over numel draws.
        np.testing.assert_allclose(float(params[key].std()), fan_in ** -0.5,
                                   rtol=4 / np.sqrt(2 * params[key].numel()), err_msg=key)


def test_config_and_builder_errors_are_jax():
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.models import moe as jmoe
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    for kw in ({"n_experts": 1}, {"d_model": 15}):
        with pytest.raises(ValueError) as want:
            jmoe.MoETransformerLMConfig(**dict(TINY, **kw))
        with pytest.raises(ValueError, match=str(want.value)):
            moe.MoETransformerLMConfig(**dict(TINY, **kw))
    with pytest.raises(ValueError, match="num_experts must be >= 2"):
        tstrategy.ExpertParallel(num_experts=1)
    info = {"nodes": [{"address": "localhost", "tpus": 8}]}
    tspec = ModelSpec(from_jax_params(_jax()[1]))
    for kw in ({"num_experts": 4, "expert_axis_size": 3}, {"num_experts": 6,
                                                           "expert_axis_size": 4}):
        with pytest.raises(ValueError) as want:
            jstrategy.ExpertParallel(**kw).build(None, JResourceSpec(resource_info=info))
        with pytest.raises(ValueError, match=str(want.value)):
            tstrategy.ExpertParallel(**kw).build(tspec, ResourceSpec(resource_info=info))


# --------------------------------------------------------------- the spawn

def _reference():
    """One process, the whole global batch: the loss and the Adam step."""
    params = {k: v.requires_grad_() for k, v in from_jax_params(_jax()[1]).items()}
    loss = moe.make_loss_fn(moe.MoETransformerLM(_config()))(
        params, {"tokens": torch.tensor(_tokens())})
    loss.backward()
    _adam(list(params.values())).step()
    return float(loss.detach()), {k: p.detach().numpy() for k, p in params.items()}


@pytest.mark.parametrize("case,axis", EXPERT_CASES)
def test_expert_parallel_step_equals_one_rank(expert_runs, case, axis):
    """One ``AutoDist(ExpertParallel)`` Adam step over 4 ranks: the loss and
    every updated parameter equal one process's step on the same global
    batch; each rank stores ``[E/k, ...]`` of each bank (its own experts) and
    the loss read no gathered bank; replicated parameters are bit for bit
    the same on every expert rank of a data rank; a ``Saver`` round trip
    gives the storage back."""
    want_loss, want_params = _reference()
    ranks = expert_runs()
    mesh = {"data": 4 // axis, "reduce": 1, "model": 1, "seq": 1, "expert": axis, "pipe": 1}
    for rank in ranks:
        assert str(rank[f"{case}-mesh"]) == str(mesh)
        np.testing.assert_allclose(rank[f"{case}-loss"], want_loss, **LOSS)
        for key, want in want_params.items():
            np.testing.assert_allclose(rank[f"{case}-logical-{key}"], want, rtol=0,
                                       atol=LR * GRAD["atol"], err_msg=key)
            stored = rank[f"{case}-storage-{key}"]
            if "experts_" in key:
                e = rank[f"{case}-coords"][1]
                per = TINY["n_experts"] // axis
                assert stored.shape == (per,) + want.shape[1:], key
                np.testing.assert_array_equal(stored, rank[f"{case}-logical-{key}"][
                    e * per:(e + 1) * per], err_msg=key)
        assert rank[f"{case}-seen"].tolist() == [
            [TINY["n_experts"] // axis, TINY["d_model"], TINY["d_ff"]],
            [TINY["n_experts"] // axis, TINY["d_ff"], TINY["d_model"]]]
        assert bool(rank[f"{case}-restored"])
    for a in ranks:
        for b in ranks:
            if a[f"{case}-coords"][0] != b[f"{case}-coords"][0]:
                continue
            for key in want_params:
                if "experts_" not in key:
                    np.testing.assert_array_equal(a[f"{case}-storage-{key}"],
                                                  b[f"{case}-storage-{key}"], err_msg=key)


if __name__ == "__main__":
    if sys.argv[1] == "moe":
        _worker(pathlib.Path(sys.argv[2]))
