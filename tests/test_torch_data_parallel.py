"""Data parallelism in the port (the implicit all-reduce of
autodist_tpu_torch.parallel.synchronization, the runner's batch split, the
mesh's sub-groups) against the JAX package on its CPU mesh, with one set of
weights fed to both through ``from_jax_params``.

The port runs over gloo ranks, all multi-rank cases in one spawn: 4 ranks
train a data x seq mesh of 2 x 2 (``SequenceParallel(seq_axis_size=2)``),
leave that group, and ranks 0 and 1 join a group of 2 that trains the
flagship step with ``AllReduce`` (dp = 2) and 2-way accumulation on a
masked batch whose mask gives the two ranks different token counts, train
a small regression with ``has_aux`` and ``fetches=`` whose per-row and
scalar results must come back global (and through ``run_many``, stacked per
step, bit for bit), then run the flagship entry point's
tiny host smoke. Each child runs this file as
a script (``_worker``), imports torch and the port only, and writes what it
computed for the parent to compare. JAX runs on a 2-device data mesh and a
{data: 2, seq: 2} mesh of its CPU devices and is imported inside the test
functions only.

Everything is f32. Tolerances, as tests/test_torch_sequence_parallel.py
states them: the loss rtol 1e-5 and its gradients rtol 2e-4 / atol 2e-5;
after 2 Adam steps the losses rtol 1e-4 and the params atol 1e-5.
"""

import functools
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist, SequenceParallel, from_jax_params
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import sequence
from autodist_tpu_torch.runner import step_function
from autodist_tpu_torch.training import train
from test_torch_ring_attention import _free_port, join_gloo_group, ranks_running

SMALL = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
DP_BATCH, DP_SEQ, ACCUM = 8, 16, 2       # 2 micro-batches of 4 rows, 2 rows a rank
SP_BATCH, SP_SEQ = 4, 32
STEPS = 2
NODES = {n: {"nodes": [{"address": "localhost", "gpus": list(range(n))}]} for n in (1, 2, 4)}
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _config(module, dtype, attention_impl="dot"):
    return module.TransformerLMConfig(**SMALL, dtype=dtype, tied_output=False,
                                      fused_head=True, attention_impl=attention_impl)


def _dp_batches():
    """Two masked batches; in every micro-batch rank 0's rows (0-1 and 4-5)
    keep about a fifth of their tokens and rank 1's (2-3, 6-7) nearly all."""
    rng = np.random.RandomState(3)
    rank0 = np.isin(np.arange(DP_BATCH), [0, 1, 4, 5])[:, None]
    out = []
    for _ in range(STEPS):
        tokens = rng.randint(0, SMALL["vocab_size"], size=(DP_BATCH, DP_SEQ + 1))
        keep = rng.rand(DP_BATCH, DP_SEQ + 1) < np.where(rank0, 0.2, 0.95)
        keep[:, 1] = True                      # at least one target a row
        out.append({"tokens": tokens.astype(np.int32), "mask": keep.astype(np.float32)})
    return out


def _sp_tokens():
    rng = np.random.RandomState(4)
    return rng.randint(0, SMALL["vocab_size"], size=(SP_BATCH, SP_SEQ + 1)).astype(np.int32)


def _adam(p):
    return torch.optim.Adam(p, lr=1e-3, eps=1e-8)


def _aux_data():
    """A regression's weights and its batches (8 rows: 2 per rank per
    micro-batch at dp = 2 with 2-way accumulation)."""
    rng = np.random.RandomState(11)
    w = rng.randn(5, 3).astype(np.float32)
    return w, [{"x": rng.randn(DP_BATCH, 5).astype(np.float32),
                "y": rng.randn(DP_BATCH, 3).astype(np.float32)} for _ in range(STEPS)]


def _aux_loss(p, b):
    """``(loss, aux)``: aux holds a per-row leaf and a scalar."""
    pred = b["x"] @ p["w"]
    per_row = ((b["y"] - pred) ** 2).mean(-1)
    return per_row.mean(), {"per_row": per_row, "pred_mean": pred.mean()}


def _aux_fetch(p, b):
    return {"pred": b["x"] @ p["w"], "w_sq": (p["w"] ** 2).sum()}


def _as_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------------ the ranks

def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    results = {}

    # data x seq = 2 x 2 over the 4 ranks.
    model = tlm.TransformerLM(_config(tlm, torch.float32, "ring"))
    ad = AutoDist(resource_info=NODES[4], strategy_builder=SequenceParallel(2), device="cpu")
    runner = sequence.create_sequence_parallel_session(ad, model, params, _adam)
    batch = {"tokens": torch.tensor(_sp_tokens())}
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads, loss, _ = runner._grad_fn(leaves, runner.shard_batch(batch))
    results["sp-mesh"] = np.array([runner.mesh.coords["data"], runner.mesh.coords["seq"]])
    results["sp-loss"] = loss.numpy()
    results.update({f"sp-grad-{k}": g.numpy() for k, g in grads.items()})
    step = step_function(runner, params)
    results["sp-losses"] = np.array([float(step(batch)) for _ in range(STEPS)])
    results.update({f"sp-param-{k}": v.detach().numpy()
                    for k, v in step.get_state().params.items()})
    dist.destroy_process_group()

    # Ranks 0 and 1: the flagship step over a data mesh of 2.
    if rank < 2:
        os.environ.update(WORLD_SIZE="2", MASTER_PORT=(workdir / "port2").read_text())
        join_gloo_group()
        model = tlm.TransformerLM(_config(tlm, torch.float32))
        batches = [_as_torch(b) for b in _dp_batches()]
        ad = AutoDist(resource_info=NODES[2], strategy_builder=AllReduce(), device="cpu")
        one = ad.create_distributed_session(tlm.make_loss_fn(model), params, _adam)
        micro = {k: v[:DP_BATCH // ACCUM] for k, v in batches[0].items()}
        sharded = one.shard_batch(micro)
        results["dp-mask-count"] = sharded["mask"][:, 1:].sum().numpy()
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads, loss, _ = one._grad_fn(leaves, sharded)
        results["dp-loss"] = loss.numpy()
        results.update({f"dp-grad-{k}": g.numpy() for k, g in grads.items()})
        step = AutoDist(resource_info=NODES[2], strategy_builder=AllReduce(),
                        device="cpu").function(tlm.make_loss_fn(model), params, _adam,
                                               accumulation_steps=ACCUM)
        results["dp-losses"] = np.array([float(step(b)) for b in batches])
        results["dp-eval"] = step.evaluate(batches[0]).numpy()
        results.update({f"dp-param-{k}": v.detach().numpy()
                        for k, v in step.get_state().params.items()})
        # train() over both ranks: collective saves (rank 0 writes) and the
        # prefetching feed.
        runner = AutoDist(resource_info=NODES[2], strategy_builder=AllReduce(),
                          device="cpu").create_distributed_session(
            tlm.make_loss_fn(model), params, _adam, accumulation_steps=ACCUM)
        train(runner, params, lambda i: batches[i], steps=STEPS, save_every=1, log_every=0,
              checkpoint_dir=str(workdir / "ckpt"), prefetch_depth=2)
        # has_aux and fetches= under dp = 2: the global arrays.
        w, aux_batches = _aux_data()
        aux_step = AutoDist(resource_info=NODES[2], strategy_builder=AllReduce(),
                            device="cpu").function(
            _aux_loss, {"w": torch.tensor(w)}, lambda p: torch.optim.SGD(p, lr=0.1),
            has_aux=True, accumulation_steps=ACCUM)
        for i, b in enumerate(aux_batches):
            (loss, aux), fetched = aux_step(_as_torch(b), fetches=_aux_fetch)
            results[f"aux{i}-loss"] = loss.numpy()
            results.update({f"aux{i}-{k}": v.numpy() for k, v in {**aux, **fetched}.items()})
        # run_many over the same 2 ranks: one block of the aux batches.
        many = AutoDist(resource_info=NODES[2], strategy_builder=AllReduce(),
                        device="cpu").create_distributed_session(
            _aux_loss, {"w": torch.tensor(w)}, lambda p: torch.optim.SGD(p, lr=0.1),
            has_aux=True, accumulation_steps=ACCUM)
        many_state = many.init({"w": torch.tensor(w)})
        _, ((loss, aux), fetched) = many.run_many(
            many_state, [_as_torch(b) for b in aux_batches], fetches=_aux_fetch)
        results["many-loss"] = loss.numpy()
        results.update({f"many-{k}": v.numpy() for k, v in {**aux, **fetched}.items()})
        results["many-w"] = many_state.params["w"].detach().numpy()
        results["aux-w"] = aux_step.get_state().params["w"].detach().numpy()
        from autodist_tpu_torch.examples import flagship_lm
        flagship_lm.main(["--device", "cpu", "--micro_batch", "2", "--seq_len", "16",
                          "--accum", "2", "--d_model", "32", "--n_layers", "1",
                          "--vocab", "64", "--steps", "1"])
        dist.destroy_process_group()
    np.savez(workdir / f"dp_rank{rank}.npz", **results)


@functools.cache
def _jax_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    return jax.device_get(jlm.init_params(_config(jlm, np.float32), jax.random.PRNGKey(6))[1])


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The 4-rank spawn, started at once; calling it waits and returns
    ``([{key: array} of each rank], [each rank's output], the 2-rank
    train()'s checkpoint directory)``."""
    workdir = tmp_path_factory.mktemp("dp")
    flat = {k: v.numpy() for k, v in from_jax_params(_jax_params()).items()}
    np.savez(workdir / "params.npz", **flat)
    (workdir / "port2").write_text(str(_free_port()))
    with ranks_running(pathlib.Path(__file__), 4, "dp", workdir) as wait:

        @functools.cache
        def results():
            logs = wait()
            return [dict(np.load(workdir / f"dp_rank{r}.npz")) for r in range(4)], logs, \
                workdir / "ckpt"

        yield results


def _jax_runner(jlm_loss, n_devices, builder, axes, accumulation_steps=1):
    """The JAX package's runner on a mesh of its first ``n_devices`` CPU
    devices, the strategy compiled for that many."""
    import jax
    import optax
    import autodist_tpu
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.plan import ShardingPlan as JPlan
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.runner import DistributedRunner as JRunner

    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=NODES[n_devices]), builder)
    spec = JModelSpec(_jax_params())
    compiled = ad._compile(spec)
    mesh = build_mesh(axes=axes, devices=jax.devices()[:n_devices])
    loss_fn = jlm_loss(mesh)
    return JRunner(compiled, spec, loss_fn, optax.adam(1e-3), mesh=mesh,
                   plan=JPlan.from_strategy(compiled, spec),
                   accumulation_steps=accumulation_steps)


def _train_jax(runner, batches):
    import jax
    state = runner.init(_jax_params())
    losses = []
    for batch in batches:
        state, loss = runner.run(state, batch)
        losses.append(float(loss))
    return state, losses, from_jax_params(jax.device_get(runner.logical_params(state)))


def _assert_params(got, want, prefix):
    for key, p in want.items():
        np.testing.assert_allclose(got[f"{prefix}-param-{key}"], p.detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


def test_two_rank_data_parallel_matches_jax(dp_runs):
    """dp = 2 with unequal mask counts: the masked loss and its synchronized
    gradients on one micro-batch against JAX ``value_and_grad`` of the
    global loss; 2 Adam steps with 2-way accumulation against the JAX runner
    on a 2-device data mesh; the evaluated loss is the global one. Both
    ranks hold the same numbers."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.strategy import AllReduce as JAllReduce

    ranks = dp_runs()[0][:2]
    counts = [float(r["dp-mask-count"]) for r in ranks]
    assert counts[0] < counts[1] / 2, counts          # the ranks' token counts differ
    jmodel = jlm.TransformerLM(_config(jlm, jnp.float32))
    jloss = jlm.make_loss_fn(jmodel)
    batches = _dp_batches()
    micro = {k: jnp.asarray(v[:DP_BATCH // ACCUM]) for k, v in batches[0].items()}
    loss, grads = jax.jit(jax.value_and_grad(jloss))(_jax_params(), micro)
    want_grads = from_jax_params(jax.device_get(grads))
    runner = _jax_runner(lambda mesh: jloss, 2, JAllReduce(), {"data": 2},
                         accumulation_steps=ACCUM)
    state, losses, params = _train_jax(runner, batches)
    evaluated = float(runner.evaluate(state, batches[0]))
    for got in ranks:
        np.testing.assert_allclose(got["dp-loss"], float(loss), **LOSS)
        for key, g in want_grads.items():
            np.testing.assert_allclose(got[f"dp-grad-{key}"], g.numpy(), err_msg=key, **GRAD)
        np.testing.assert_allclose(got["dp-losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(got["dp-eval"], evaluated, rtol=1e-4)
        _assert_params(got, params, "dp")


def test_two_rank_aux_and_fetches_are_global(dp_runs):
    """Under dp = 2 with 2-way accumulation, ``has_aux`` and ``fetches=``
    results equal the JAX package's global arrays on its 2-device mesh:
    per-row leaves gathered in the batch's row order, scalars averaged; on
    both ranks."""
    import jax
    import jax.numpy as jnp
    import optax
    import autodist_tpu
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.plan import ShardingPlan as JPlan
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.runner import DistributedRunner as JRunner
    from autodist_tpu.strategy import AllReduce as JAllReduce

    def loss(p, b):
        pred = b["x"] @ p["w"]
        per_row = jnp.mean((b["y"] - pred) ** 2, axis=-1)
        return jnp.mean(per_row), {"per_row": per_row, "pred_mean": jnp.mean(pred)}

    def fetch(p, b):
        return {"pred": b["x"] @ p["w"], "w_sq": jnp.sum(p["w"] ** 2)}

    w, batches = _aux_data()
    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=NODES[2]), JAllReduce())
    spec = JModelSpec({"w": w})
    compiled = ad._compile(spec)
    runner = JRunner(compiled, spec, loss, optax.sgd(0.1), has_aux=True,
                     mesh=build_mesh(axes={"data": 2}, devices=jax.devices()[:2]),
                     plan=JPlan.from_strategy(compiled, spec), accumulation_steps=ACCUM)
    state = runner.init({"w": w})
    ranks = dp_runs()[0][:2]
    for i, b in enumerate(batches):
        state, ((jloss, jaux), jfetched) = runner.run(state, b, fetches=fetch)
        want = {"loss": jloss, **jaux, **jfetched}
        for got in ranks:
            for key, value in want.items():
                value = np.asarray(value)
                assert got[f"aux{i}-{key}"].shape == value.shape, key
                np.testing.assert_allclose(got[f"aux{i}-{key}"], value, rtol=1e-5,
                                           atol=1e-6, err_msg=key)


def test_two_rank_run_many_equals_run(dp_runs):
    """``run_many`` over a block of the aux batches under dp = 2 with 2-way
    accumulation gives, on both ranks, the ``run()`` steps' global losses,
    aux and fetched results stacked on a leading step axis, bit for bit,
    and the same weights after."""
    for got in dp_runs()[0][:2]:
        np.testing.assert_array_equal(got["many-w"], got["aux-w"])
        for key in ("loss", "per_row", "pred_mean", "pred", "w_sq"):
            want = np.stack([got[f"aux{i}-{key}"] for i in range(STEPS)])
            np.testing.assert_array_equal(got[f"many-{key}"], want, err_msg=key)


def test_two_rank_data_parallel_equals_one_process(dp_runs):
    """The same 2 steps in one process (dp = 1, the whole batch)."""
    ranks = dp_runs()[0][:2]
    model = tlm.TransformerLM(_config(tlm, torch.float32))
    step = AutoDist(resource_info=NODES[1], strategy_builder=AllReduce(), device="cpu") \
        .function(tlm.make_loss_fn(model), from_jax_params(_jax_params()), _adam,
                  accumulation_steps=ACCUM)
    losses = [float(step(_as_torch(b))) for b in _dp_batches()]
    for got in ranks:
        np.testing.assert_allclose(got["dp-losses"], losses, rtol=1e-4)
        _assert_params(got, step.get_state().params, "dp")


def test_data_by_seq_mesh_matches_jax(dp_runs):
    """A 2 x 2 data x seq mesh over 4 ranks (rank = data * 2 + seq, as the
    JAX package reshapes its devices): the sequence-parallel loss and its
    gradients, and 2 Adam steps of the session, against JAX on its
    {data: 2, seq: 2} mesh; every rank holds the same numbers."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.parallel.sequence import make_sequence_parallel_loss_fn
    from autodist_tpu.strategy import SequenceParallel as JSequenceParallel

    ranks = dp_runs()[0]
    assert [tuple(r["sp-mesh"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    jmodel = jlm.TransformerLM(_config(jlm, jnp.float32, "ring"))
    runner = _jax_runner(lambda mesh: make_sequence_parallel_loss_fn(jmodel, mesh), 4,
                         JSequenceParallel(seq_axis_size=2), {"data": 2, "seq": 2})
    tokens = {"tokens": jnp.asarray(_sp_tokens())}
    with runner.mesh:
        loss, grads = jax.jit(jax.value_and_grad(runner._loss_fn))(_jax_params(), tokens)
    want_grads = from_jax_params(jax.device_get(grads))
    _, losses, params = _train_jax(runner, [{"tokens": _sp_tokens()}] * STEPS)
    for got in ranks:
        np.testing.assert_allclose(got["sp-loss"], float(loss), **LOSS)
        for key, g in want_grads.items():
            np.testing.assert_allclose(got[f"sp-grad-{key}"], g.numpy(), err_msg=key, **GRAD)
        np.testing.assert_allclose(got["sp-losses"], losses, rtol=1e-4)
        _assert_params(got, params, "sp")


def test_two_rank_train_saves_once_and_restores(dp_runs):
    """train() over the 2 ranks saved every step from rank 0 alone; the
    last checkpoint holds the params the 2-rank steps reached."""
    ranks, _, ckpt = dp_runs()
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "checkpoint", "model-1.json", "model-1.npz", "model-2.json", "model-2.npz"]
    params = Saver().restore(Saver.latest_checkpoint(str(ckpt), name="model"))
    for key, value in params.items():
        np.testing.assert_array_equal(value.numpy(), ranks[0][f"dp-param-{key}"], err_msg=key)


def test_flagship_entry_point_over_two_ranks(dp_runs):
    """``flagship_lm`` under a group of 2: the global batch is 2 per rank x
    2 ranks x 2 micro-batches, and only rank 0 prints its line."""
    logs = dp_runs()[1]
    assert '"metric": "transformer_lm_train_tokens_per_sec (cpu x2, d32x1, seq16, ' \
           'bs8=4x2accum)"' in logs[0]
    assert '"mfu": null' in logs[0]
    assert "transformer_lm_train_tokens_per_sec" not in logs[1]


if __name__ == "__main__":
    if sys.argv[1] == "dp":
        _worker(pathlib.Path(sys.argv[2]))
