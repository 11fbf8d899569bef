"""The port's pipeline schedules, pipeline LM and ``Pipeline`` strategy
(autodist_tpu_torch.parallel.pipeline, models.pipeline_lm,
strategy.pipeline_strategy) against the JAX package's.

Without a spawn: the layout helpers, ``sequential_apply``, the GPipe, 1F1B
and interleaved-1F1B schedules run in the one-process replay (S = 4, v = 2)
against JAX's ``jax.value_and_grad`` over ``sequential_apply`` for every
leaf, the strategies, compiled strategies and plans for 8 devices, the
sparse flags and the errors. JAX runs once, at f32, on weights drawn from a
numpy seed at the JAX init's scales. Then 4 gloo ranks, every case in one
spawn (the pattern of tests/test_torch_ulysses.py): a pipe 4 and a pipe 2 x
data 2 mesh, each rank running this file as a script (torch and the port
only).

Tolerances at f32: losses rtol 1e-5 and gradients atol 1e-4, BERT's and
NCF's; the layout helpers exactly.
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
from autodist_tpu_torch.models import pipeline_lm as plm
from autodist_tpu_torch.parallel import pipeline
from autodist_tpu_torch.parallel.mesh import build_mesh, replay_mesh
from autodist_tpu_torch.parallel.plan import ShardingPlan
from autodist_tpu_torch.resource_spec import ResourceSpec
from test_torch_ring_attention import join_gloo_group, ranks_running

RANKS = 4
TINY = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=8, d_ff=32, max_len=32,
            num_microbatches=4)
BATCH, SEQ = 8, 16
FOUR_GPUS = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=0, atol=1e-4)
# (case, n_stages, n_chunks) of the spawn: the mesh is pipe n_stages x data rest.
PIPE_CASES = (("pipe4", 4, 1), ("pipe2-data2", 2, 1), ("pipe4-v2", 4, 2),
              ("pipe2-data2-v2", 2, 2))
LR, EPS = 0.1, 1.0


def _config(n_stages=4, n_chunks=2, dtype=torch.float32, **kw) -> plm.PipelineLMConfig:
    return plm.PipelineLMConfig(**dict(TINY, **kw), n_stages=n_stages, n_chunks=n_chunks,
                                dtype=dtype)


def _weights():
    """The JAX tree, drawn from a numpy seed at the JAX init's scales."""
    rng = np.random.RandomState(5)
    d, f, n, v = TINY["d_model"], TINY["d_ff"], TINY["n_layers"], TINY["vocab_size"]

    def normal(shape, scale):
        return (scale * rng.randn(*shape)).astype(np.float32)

    return {"embed": normal((v, d), 0.02), "pos": normal((TINY["max_len"], d), 0.02),
            "blocks": {"ln1_s": 1 + normal((n, d), 0.1), "ln1_b": normal((n, d), 0.1),
                       "wqkv": normal((n, d, 3 * d), d ** -0.5),
                       "wo": normal((n, d, d), d ** -0.5),
                       "ln2_s": 1 + normal((n, d), 0.1), "ln2_b": normal((n, d), 0.1),
                       "w1": normal((n, d, f), d ** -0.5), "w2": normal((n, f, d), f ** -0.5)},
            "ln_f_s": 1 + normal((d,), 0.1), "ln_f_b": normal((d,), 0.1),
            "head": normal((d, v), d ** -0.5)}


def _tokens():
    rng = np.random.RandomState(6)
    return rng.randint(0, TINY["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


def _adam(params):
    return torch.optim.Adam(params, lr=LR, eps=EPS)


def _sequential(cfg, params):
    """The port's loss over ``sequential_apply`` and its gradients."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    tokens = torch.tensor(_tokens()).long()
    logits = plm.sequential_apply(plm.PipelineLM(cfg), leaves, tokens[:, :-1])
    loss = plm._nll(logits, tokens[:, 1:]).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# ------------------------------------------------------------------ the ranks

def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    batch = {"tokens": torch.tensor(np.load(workdir / "tokens.npy"))}
    results = {}
    for case, s, v in PIPE_CASES:
        cfg = _config(s, v)
        model = plm.PipelineLM(cfg)
        if v == 1:
            # GPipe through AutoDist(Pipeline): one Adam step.
            seen, base = [], plm.make_loss_fn(model)

            def loss_fn(p, b):
                seen.append({k: tuple(t.shape) for k, t in p.items() if k.startswith(plm.BLOCKS)})
                return base(p, b)

            ad = AutoDist(resource_info=FOUR_GPUS, device="cpu",
                          strategy_builder=tstrategy.Pipeline(n_stages=s))
            step = ad.function(loss_fn, params, _adam, example_batch=batch)
            del seen[:]                  # the walk's trace at the logical shapes
            results[f"{case}-loss"] = step(batch).numpy()
            results[f"{case}-seen"] = np.array(sorted({t[0] for call in seen
                                                       for t in call.values()}))
            runner, state = step.runner, step.get_state()
            mesh = runner.mesh
            results[f"{case}-mesh"] = np.array(str(dict(runner.plan.mesh_axes)))
            for key, t in state.params.items():
                results[f"{case}-storage-{key}"] = t.detach().numpy()
            for key, t in runner.logical_params(state).items():
                results[f"{case}-logical-{key}"] = t.detach().numpy()
        else:
            mesh = build_mesh(axes={"pipe": s, "data": RANKS // s})
        pipe = mesh.coords["pipe"]
        results[f"{case}-pipe"] = np.array(pipe)
        # 1F1B (interleaved at v = 2) on this rank's rows of the stored stack.
        rows = cfg.n_layers // s
        local = {k: t[pipe * rows:(pipe + 1) * rows] if k.startswith(plm.BLOCKS) else t
                 for k, t in params.items()}
        with mesh:
            loss, grads = plm.make_onef_oneb_value_and_grad(model)(local, batch)
            if v > 1:
                # GPipe over the stored (device-major) stack: one gather of
                # the stack over the pipe ranks, its transpose on the way back.
                leaves = {k: t.clone().requires_grad_() for k, t in local.items()}
                gloss = plm.make_loss_fn(model)(leaves, batch)
                results[f"{case}-gpipe-loss"] = gloss.detach().numpy()
                results.update({f"{case}-gpipe-{k}": g.numpy() for k, g in zip(
                    leaves, torch.autograd.grad(gloss, list(leaves.values())))})
            try:
                plm.make_loss_fn(plm.PipelineLM(_config(6 - s, 1)))(local, batch)
                results[f"{case}-mismatch"] = np.array("no error")
            except ValueError as e:
                results[f"{case}-mismatch"] = np.array(str(e))
        results[f"{case}-1f1b-loss"] = loss.numpy()
        results.update({f"{case}-1f1b-{k}": g.numpy() for k, g in grads.items()})
    np.savez(workdir / f"pipe_rank{rank}.npz", **results)
    dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def pipe_runs(tmp_path_factory):
    """The 4-rank run, started before the file's first test (the others run
    meanwhile); calling it waits for the ranks and returns their results,
    rank by rank."""
    workdir = tmp_path_factory.mktemp("pipe")
    np.savez(workdir / "params.npz",
             **{k: v.numpy() for k, v in from_jax_params(_weights()).items()})
    np.save(workdir / "tokens.npy", _tokens())
    with ranks_running(pathlib.Path(__file__), RANKS, "pipe", workdir) as wait:

        @functools.cache
        def results():
            wait()
            return [dict(np.load(workdir / f"pipe_rank{r}.npz")) for r in range(RANKS)]

        yield results


@functools.cache
def _jax():
    """JAX's loss and gradients over ``sequential_apply`` of the S = 4, v = 2
    model (blocks stored device-major): the one JAX compile of the file."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import pipeline_lm as jplm
    cfg = jplm.PipelineLMConfig(**TINY, n_stages=4, n_chunks=2, dtype=jnp.float32)
    model = jplm.PipelineLM(cfg)

    def seq_loss(params, tokens):
        logits = jplm.sequential_apply(model, params, tokens[:, :-1])
        logprobs = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logprobs, tokens[:, 1:, None], axis=-1)[..., 0].mean()

    loss, grads = jax.jit(jax.value_and_grad(seq_loss))(_weights(), _tokens())
    return float(loss), from_jax_params(jax.device_get(grads))


def _execution_order(cfg, flat):
    """A flat params dict with its block stacks in execution order."""
    blocks = plm.blocks_to_execution_order(cfg, plm._blocks(flat))
    return dict(flat, **{plm.BLOCKS + k: v for k, v in blocks.items()})


# ----------------------------------------------------------- without a spawn

def test_layout_helpers_match_jax():
    """``chunk_perm``, ``interleave_chunk_layout``, ``layer_execution_order``
    and the execution-order round trip, exactly."""
    import jax.numpy as jnp
    from autodist_tpu.models import pipeline_lm as jplm
    from autodist_tpu.parallel import pipeline as jpipe
    for s, v in ((3, 2), (4, 2), (2, 4), (4, 1)):
        for inverse in (False, True):
            assert pipeline.chunk_perm(s, v, inverse) == jpipe.chunk_perm(s, v, inverse)
            x = np.arange(s * v * 3).reshape(s * v, 3)
            np.testing.assert_array_equal(
                pipeline.interleave_chunk_layout({"w": torch.tensor(x)}, s, v, inverse)[
                    "w"].numpy(),
                np.asarray(jpipe.interleave_chunk_layout({"w": x}, s, v, inverse)["w"]))
        if TINY["n_layers"] % (s * v) == 0:
            cfg = _config(s, v)
            jcfg = jplm.PipelineLMConfig(**TINY, n_stages=s, n_chunks=v, dtype=jnp.float32)
            assert plm.layer_execution_order(cfg) == jplm.layer_execution_order(jcfg)
            blocks = _weights()["blocks"]
            exe = plm.blocks_to_execution_order(cfg, from_jax_params(blocks))
            jexe = jplm.blocks_to_execution_order(jcfg, blocks)
            for k, a in exe.items():
                np.testing.assert_array_equal(a.numpy(), np.asarray(jexe[k]), err_msg=k)
            back = plm.blocks_from_execution_order(cfg, exe)
            for k, a in back.items():
                np.testing.assert_array_equal(a.numpy(), blocks[k], err_msg=k)


def test_sequential_apply_matches_jax():
    import jax.numpy as jnp
    from autodist_tpu.models import pipeline_lm as jplm
    jcfg = jplm.PipelineLMConfig(**TINY, n_stages=4, n_chunks=2, dtype=jnp.float32)
    tokens = _tokens()[:, :-1]
    want = jplm.sequential_apply(jplm.PipelineLM(jcfg), _weights(), jnp.asarray(tokens))
    got = plm.sequential_apply(plm.PipelineLM(_config()), from_jax_params(_weights()),
                               torch.tensor(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved", "gpipe-interleaved"])
def test_schedule_replayed_matches_jax_sequential(schedule):
    """Each schedule at S = 4 (v = 2 for the interleaved ones) in the
    one-process replay: the loss and every leaf's gradient equal JAX's
    ``value_and_grad`` over ``sequential_apply``. The plain schedules run
    the S = 4, v = 1 model on the same layers in execution order (its
    stored order), so their block gradients are JAX's in execution order."""
    want_loss, want = _jax()
    v = 2 if "interleaved" in schedule else 1
    cfg, params = _config(4, v), from_jax_params(_weights())
    if v == 1:
        params = _execution_order(_config(4, 2), params)
        want = _execution_order(_config(4, 2), want)
    model = plm.PipelineLM(cfg)
    batch = {"tokens": torch.tensor(_tokens())}
    with replay_mesh({"pipe": 4}):
        if schedule.startswith("gpipe"):
            leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
            loss = plm.make_loss_fn(model)(leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        else:
            loss, grads = plm.make_onef_oneb_value_and_grad(model)(params, batch)
    np.testing.assert_allclose(float(loss.detach()), want_loss, **LOSS)
    assert sorted(grads) == sorted(want)
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), g.numpy(), err_msg=key, **GRAD)


def test_one_stage_schedules_degenerate():
    """S = 1: GPipe is the stage on every micro-batch and 1F1B the mean of
    the micro-batches' value and grad (``pipeline.py:62-67,125-148``)."""
    rng = np.random.RandomState(2)
    w, head = torch.tensor(rng.randn(1, 8, 8) * 0.3), torch.tensor(rng.randn(8, 3) * 0.3)
    x, tgt = torch.tensor(rng.randn(4, 2, 8)), torch.tensor(rng.randn(4, 2, 3))

    def stage_fn(p, x):
        return torch.tanh(x @ p[0])

    def tail_fn(tp, y, t):
        return ((y @ tp - t) ** 2).mean()

    with replay_mesh({"pipe": 1}):
        loss, gs, gt, gx = pipeline.pipelined_value_and_grad(stage_fn, tail_fn, 1)(
            w, head, x, tgt)
        ws, hs, xs = (a.clone().requires_grad_() for a in (w, head, x))
        y = pipeline.pipelined(stage_fn, 1)(ws, xs)
    want = torch.stack([tail_fn(hs, y[k], tgt[k]) for k in range(4)]).mean()
    for got, ref in zip((gs, gt, gx), torch.autograd.grad(want, [ws, hs, xs])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-12)


@pytest.mark.parametrize("mesh", [None, {"pipe": 4, "reduce": 2}])
def test_pipeline_builds_compiles_and_plans_as_jax(mesh):
    """8 devices, ``n_stages=4``: the built and compiled strategies field by
    field and the plan's specs (with the default mesh and a resource-spec one)."""
    from google.protobuf.json_format import MessageToDict

    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.parallel.plan import ShardingPlan as JPlan
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    info = {"nodes": [{"address": "localhost", "tpus": 8}], **({"mesh": mesh} if mesh else {})}
    jspec = JModelSpec.from_params(_weights())
    tspec = ModelSpec(from_jax_params(_weights()))
    jres, tres = JResourceSpec(resource_info=info), ResourceSpec(resource_info=info)
    jbuilt, tbuilt = (s.Pipeline(n_stages=4).build(spec, res) for s, spec, res in
                      ((jstrategy, jspec, jres), (tstrategy, tspec, tres)))
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
    assert tplan.mesh_axes["pipe"] == 4
    for name, jp in jplan.params.items():
        tp = tplan.params[name]
        assert (tp.pspec, tp.opt_pspec, tp.partition_mesh_axis, tp.num_shards) == (
            tuple(jp.pspec), tuple(jp.opt_pspec), jp.partition_mesh_axis, jp.num_shards), name
    assert sum(p.pspec[:1] == ("pipe",) for p in tplan.params.values()) == 8


def test_sparse_flags_match_jax():
    """The walk marks no parameter sparse, as JAX's: the GPipe loss raises
    "needs a mesh" outside one, in both traces, and the walk catches it."""
    import jax.numpy as jnp
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.models import pipeline_lm as jplm
    jcfg = jplm.PipelineLMConfig(**TINY, n_stages=4, dtype=jnp.float32)
    batch = {"tokens": _tokens()}
    want = JModelSpec.from_loss_fn(jplm.make_loss_fn(jplm.PipelineLM(jcfg)), _weights(), batch)
    got = ModelSpec.from_loss_fn(plm.make_loss_fn(plm.PipelineLM(_config(4, 1))),
                                 from_jax_params(_weights()), batch)
    assert [n for n, p in got.params.items() if p.sparse] == \
        [n for n, p in want.params.items() if p.sparse] == []


def test_config_and_mesh_errors_are_jax():
    """The config checks, ``Pipeline``'s, the mesh whose pipe size is not
    ``n_stages``, a stage leaf of the wrong leading dim, the interleaved
    schedule's ragged micro-batches and the call outside any mesh raise
    JAX's errors."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu import strategy as jstrategy
    from autodist_tpu.models import pipeline_lm as jplm
    from autodist_tpu.parallel import pipeline as jpipe
    from autodist_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

    def same(jcall, tcall, kind=ValueError):
        with pytest.raises(kind) as want:
            jcall()
        with pytest.raises(kind) as got:
            tcall()
        assert str(got.value) == str(want.value)

    for kw in ({"n_layers": 6}, {"n_chunks": 2, "num_microbatches": 6}, {"d_model": 15}):
        same(lambda: jplm.PipelineLMConfig(**dict(TINY, n_stages=4, **kw)),
             lambda: plm.PipelineLMConfig(**dict(TINY, n_stages=4, **kw)))
    same(lambda: jstrategy.Pipeline(n_stages=1), lambda: tstrategy.Pipeline(n_stages=1))
    info = {"nodes": [{"address": "localhost", "tpus": 6}]}
    same(lambda: jstrategy.Pipeline(n_stages=4).build(None, JResourceSpec(resource_info=info)),
         lambda: tstrategy.Pipeline(n_stages=4).build(None, ResourceSpec(resource_info=info)))

    x = np.zeros((2, 2, 2), np.float32)
    jmesh = jbuild_mesh(axes={"pipe": 2, "data": -1})
    f = jpipe.pipelined(lambda p, x: x, n_stages=4, mesh=jmesh)
    same(lambda: jax.jit(f)(jnp.zeros((4, 2, 2)), x),
         lambda: pipeline.pipelined(lambda p, x: x, 4, mesh=replay_mesh({"pipe": 2}))(
             torch.zeros(4, 2, 2), torch.tensor(x)))
    same(lambda: jax.jit(jpipe.pipelined(lambda p, x: x, 4))(jnp.zeros((4, 2, 2)), x),
         lambda: pipeline.pipelined(lambda p, x: x, 4)(torch.zeros(4, 2, 2), torch.tensor(x)),
         RuntimeError)
    jmesh = jbuild_mesh(axes={"pipe": 4, "data": -1})
    rng = np.random.RandomState(0)
    w, head = rng.randn(8, 2, 2).astype(np.float32), rng.randn(2, 3).astype(np.float32)
    x5, t5 = rng.randn(5, 2, 2).astype(np.float32), rng.randn(5, 2, 3).astype(np.float32)
    args = ({"w": w}, head, x5[:4], t5[:4])

    def jil(*a):
        return jax.jit(jpipe.interleaved_value_and_grad(
            lambda p, x: x @ p["w"][0], lambda tp, y, t: ((y @ tp - t) ** 2).mean(), 4, 2,
            mesh=jmesh))(*a)

    def til(*a):
        a = [{k: torch.tensor(v) for k, v in t.items()} if isinstance(t, dict)
             else torch.tensor(t) for t in a]
        return pipeline.interleaved_value_and_grad(
            lambda p, x: x @ p["w"][0], lambda tp, y, t: ((y @ tp - t) ** 2).mean(), 4, 2,
            mesh=replay_mesh({"pipe": 4}))(*a)

    same(lambda: jil(args[0], head, x5, t5), lambda: til(args[0], head, x5, t5))
    same(lambda: jil(dict(args[0], gain=np.ones((), np.float32)), *args[1:]),
         lambda: til(dict(args[0], gain=np.ones((), np.float32)), *args[1:]))


# --------------------------------------------------------------- the spawn

@functools.lru_cache(maxsize=None)
def _reference(n_stages, n_chunks):
    """One process, the whole batch: the sequential loss and gradients, and
    the params after one Adam step on them."""
    cfg, params = _config(n_stages, n_chunks), from_jax_params(_weights())
    loss, grads = _sequential(cfg, params)
    leaves = [p.clone().requires_grad_() for p in params.values()]
    for leaf, g in zip(leaves, grads.values()):
        leaf.grad = g
    _adam(leaves).step()
    return float(loss), grads, {k: p.detach().numpy() for k, p in zip(params, leaves)}


@pytest.mark.parametrize("case,n_stages,n_chunks", PIPE_CASES)
def test_pipe_ranks_match_one_process(pipe_runs, case, n_stages, n_chunks):
    """Over 4 gloo ranks: 1F1B (interleaved at v = 2) on each rank's rows of
    the stored stack gives the sequential loss and gradients, each rank its
    rows of the blocks' and the whole of the others' (so does GPipe over the
    interleaved stack, which gathers it over the pipe ranks); a model whose
    ``n_stages`` is not the mesh's pipe size raises; and at v = 1 the GPipe
    ``AutoDist(Pipeline)`` Adam step equals one process's, each rank storing
    ``[L/S, ...]`` of each block stack (and its loss reading those rows, no
    gathered stack) and the replicated parameters the same bit for bit on
    every pipe rank."""
    want_loss, want_grads, want_params = _reference(n_stages, n_chunks)
    rows = TINY["n_layers"] // n_stages
    ranks = pipe_runs()
    for rank in ranks:
        pipe = int(rank[f"{case}-pipe"])
        np.testing.assert_allclose(rank[f"{case}-1f1b-loss"], want_loss, **LOSS)
        for key, g in want_grads.items():
            if key.startswith(plm.BLOCKS):
                g = g[pipe * rows:(pipe + 1) * rows]
            np.testing.assert_allclose(rank[f"{case}-1f1b-{key}"], g.numpy(), err_msg=key,
                                       **GRAD)
        assert "needs mesh axis 'pipe'" in str(rank[f"{case}-mismatch"])
        if n_chunks > 1:
            np.testing.assert_allclose(rank[f"{case}-gpipe-loss"], want_loss, **LOSS)
            for key, g in want_grads.items():
                if key.startswith(plm.BLOCKS):
                    g = g[pipe * rows:(pipe + 1) * rows]
                np.testing.assert_allclose(rank[f"{case}-gpipe-{key}"], g.numpy(),
                                           err_msg=key, **GRAD)
            continue
        assert str(rank[f"{case}-mesh"]) == str({
            "data": 4 // n_stages, "reduce": 1, "model": 1, "seq": 1, "expert": 1,
            "pipe": n_stages})
        np.testing.assert_allclose(rank[f"{case}-loss"], want_loss, **LOSS)
        for key, want in want_params.items():
            np.testing.assert_allclose(rank[f"{case}-logical-{key}"], want, rtol=0,
                                       atol=LR * GRAD["atol"], err_msg=key)
            stored = rank[f"{case}-storage-{key}"]
            if key.startswith(plm.BLOCKS):
                assert stored.shape[0] == rows, key
                assert rank[f"{case}-seen"].tolist() == [rows]     # no gathered stack
                np.testing.assert_array_equal(
                    stored, rank[f"{case}-logical-{key}"][pipe * rows:(pipe + 1) * rows])
            else:
                np.testing.assert_array_equal(stored, ranks[0][f"{case}-storage-{key}"],
                                              err_msg=key)


if __name__ == "__main__":
    if sys.argv[1] == "pipe":
        _worker(pathlib.Path(sys.argv[2]))
