"""The port's synchronous strategy family against the JAX package's, over
gloo ranks: PS and PSLoadBalancing with weight-update sharding, partitioned
and padded storage, PartitionedAR, Parallax's sparse wire with
error-feedback bf16, the DCN two-phase reduce, PowerSGD, ZeRO under
AllReduce, the flagship through ``AutoDist()``'s default builder, and the
sharded (v2) checkpoint write, restored in both directions.

All multi-rank cases share one spawn (``_worker``): 4 gloo ranks run the
JAX strategy matrix's configurations (``tests/strategy_matrix_mp_script.py``,
its model, batches and optimizers, the loss ported to torch) and ZeRO, then
leave that group, and ranks 0 and 1 join a group of 2 for the flagship and
the checkpoints. Each child runs this file as a script, imports torch and
the port only, and writes what it computed; the parent runs the JAX package
on the same meshes of its CPU devices and compares.

Tolerances. f32 (tests/test_torch_sequence_parallel.py's): after the
steps, losses rtol 1e-4 and params atol 1e-5. The bf16 wire (``parallax``:
BF16_EF; ``dcn``: BF16 in two phases) rounds each sum of bf16 values on
its own order, gloo adding pairwise in bf16 where XLA-CPU may add in f32:
each synchronized gradient element can move by a few bf16 half-ulps
(2^-9 relative) of the largest gradient, bounded here by 2^-6 G (G the
largest gradient element of the f32 run), so after ``STEPS`` SGD steps the
params by ``STEPS * LR * 2^-6 * G`` (plus the f32 atol) and the losses by
rtol 1e-2; the error-feedback residuals by one bf16 half-ulp of the
gradient, ``2^-9 * 2 G``.
"""

import functools
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, from_jax_params
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import synchronization
from autodist_tpu_torch.strategy import PS, AllReduce
from autodist_tpu_torch.training import train
from test_torch_ring_attention import _free_port, join_gloo_group, ranks_running

BATCH, LR, STEPS, STEPS_TOTAL = 16, 0.05, 3, 5
VOCAB, DIM = 33, 4
LOSS_TOL = dict(rtol=1e-4)
PARAM_ATOL = 1e-5
SPAWN_TIMEOUT_S = 150

# name -> (builder, mesh, optimizer): strategy_matrix_mp_script.py:106-160,
# on 4 ranks.
MATRIX = {
    "ps": ("PS", None, "adam"),
    "partitioned": ("UnevenPartitionedPS", {"model": 2, "data": -1}, "adam"),
    "parallax": ("ParallaxEF", None, "sgd"),
    "dcn": ("AllReduceDCN", {"data": 2, "reduce": 2}, "sgd"),
    "powersgd": ("AllReducePowerSGD", None, "sgd"),
    "tp_zero": ("UnevenPartitionedPS", {"model": 2, "reduce": 2, "data": -1}, "adam"),
    "par": ("PartitionedAR", {"model": 2, "data": -1}, "adam"),
}
BF16 = ("parallax", "dcn")
ZERO_BATCH, ZERO_STEPS = 32, 3
FLAGSHIP = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
FLAG_BATCH, FLAG_SEQ, FLAG_ACCUM, FLAG_STEPS = 8, 16, 2, 2


def _builder(name, jax_package=False):
    if jax_package:
        from autodist_tpu import strategy as s
    else:
        from autodist_tpu_torch import strategy as s
    return {
        "PS": lambda: s.PS(),
        "UnevenPartitionedPS": lambda: s.UnevenPartitionedPS(),
        "ParallaxEF": lambda: s.Parallax(compressor="HorovodCompressorEF"),
        "AllReduceDCN": lambda: s.AllReduce(all_reduce_spec="DCN",
                                            compressor="HorovodCompressor", chunk_size=4),
        "AllReducePowerSGD": lambda: s.AllReduce(compressor="PowerSGDCompressor",
                                                 power_sgd_rank=2),
        "PartitionedAR": lambda: s.PartitionedAR(),
        "AllReduce": lambda: s.AllReduce(),
    }[name]()


def _nodes(n, mesh=None):
    info = {"nodes": [{"address": "localhost", "gpus": list(range(n))}]}
    if mesh:
        info["mesh"] = mesh
    return info


def matrix_params():
    rng = np.random.RandomState(5)
    return {"emb": rng.randn(VOCAB, DIM).astype(np.float32) * 0.1,
            "wu": rng.randn(7, DIM).astype(np.float32) * 0.1,
            "w2": rng.randn(DIM, DIM).astype(np.float32) * 0.1,
            "b": np.zeros((DIM,), np.float32)}


def matrix_batch(step):
    rng = np.random.RandomState(2000 + step)
    return {"idx": rng.randint(0, VOCAB, (BATCH,)),
            "x": rng.randn(BATCH, 7).astype(np.float32),
            "y": rng.randn(BATCH, DIM).astype(np.float32)}


def zero_params():
    rng = np.random.RandomState(7)
    return {"w1": rng.randn(8, 16).astype(np.float32) * 0.3,
            "b1": np.zeros((16,), np.float32),
            "w2": rng.randn(16, 16).astype(np.float32) * 0.3}


def zero_batch(i):
    rng = np.random.RandomState(100 + i)
    return {"x": rng.randn(ZERO_BATCH, 8).astype(np.float32),
            "y": rng.randn(ZERO_BATCH, 16).astype(np.float32)}


# ------------------------------------------------------------- torch losses

def matrix_loss(p, b):
    rows = p["emb"][b["idx"].long()]                   # the sparse gather
    h = rows + b["x"] @ p["wu"]
    pred = h @ p["w2"] + p["b"]
    return ((b["y"] - pred) ** 2).mean()



def zero_loss(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return ((b["y"] - h @ p["w2"]) ** 2).mean()


def _optimizer(kind):
    if kind == "adam":
        return lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8)
    return lambda p: torch.optim.SGD(p, lr=LR)


def _tensors(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _flag_config(module, dtype):
    return module.TransformerLMConfig(**FLAGSHIP, dtype=dtype, tied_output=False,
                                      fused_head=True)


def flag_batches():
    rng = np.random.RandomState(8)
    return [{"tokens": rng.randint(0, FLAGSHIP["vocab_size"],
                                   size=(FLAG_BATCH, FLAG_SEQ + 1)).astype(np.int32)}
            for _ in range(FLAG_STEPS)]


# ------------------------------------------------------------------ the ranks

def _record(out, prefix, runner, state, losses):
    out[f"{prefix}-losses"] = np.array(losses)
    for k, v in runner.logical_params(state).items():
        out[f"{prefix}-param-{k}"] = v.detach().numpy().copy()


def _matrix_session(world, mesh, builder, opt, **kw):
    ad = AutoDist(resource_info=_nodes(world, mesh), strategy_builder=builder, device="cpu")
    return ad.create_distributed_session(matrix_loss, _tensors(matrix_params()),
                                         _optimizer(opt), example_batch=matrix_batch(0),
                                         **kw)


def _steps(runner, state, lo, hi, batch_fn=matrix_batch):
    return [float(runner.run(state, _tensors(batch_fn(i)))[1]) for i in range(lo, hi)]


def _four_ranks(out):
    """The strategy matrix and ZeRO on 4 ranks."""
    for config, (builder, mesh, opt) in MATRIX.items():
        runner = _matrix_session(4, mesh, _builder(builder), opt)
        state = runner.init(_tensors(matrix_params()))
        if config == "powersgd":
            out["powersgd-q0-w2"] = state.ef_state["w2"]["q"].numpy().copy()
        _record(out, config, runner, state, _steps(runner, state, 0, STEPS))
        moments = state.optimizer.state[state.opt_params["w2"]]
        if "exp_avg" in moments:
            out[f"{config}-w2-opt-shape"] = np.array(moments["exp_avg"].shape)
            wu_mom = state.optimizer.state[state.opt_params["wu"]]
            out[f"{config}-wu-moments"] = np.stack([
                runner.layout.gather(wu_mom[f], runner.plan.params["wu"].opt_pspec).numpy()
                for f in ("exp_avg", "exp_avg_sq")])
        out[f"{config}-wu-storage"] = runner.layout.gather(
            state.params["wu"].detach(), runner.plan.params["wu"].pspec).numpy()
        out[f"{config}-wu-local-shape"] = np.array(state.params["wu"].shape)
        out[f"{config}-wire"] = np.array(sorted(runner.plan.sparse_wire_params), dtype=str)
        out[f"{config}-explicit"] = np.array(runner._grad_fn.explicit)
        for key, entry in state.ef_state.items():
            out[f"{config}-ef-{key}"] = entry["error"].numpy().copy()
    # ZeRO under AllReduce (tests/test_dp_zero_update.py), and its zero=0 twin.
    for zero in (1, 0):
        ad = AutoDist(resource_info=_nodes(4), strategy_builder=AllReduce(), device="cpu")
        runner = ad.create_distributed_session(zero_loss, _tensors(zero_params()),
                                               _optimizer("adam"), zero=zero)
        state = runner.init(_tensors(zero_params()))
        _record(out, f"zero{zero}", runner, state,
                _steps(runner, state, 0, ZERO_STEPS, zero_batch))
        out[f"zero{zero}-opt-shapes"] = np.array(
            [state.optimizer.state[state.opt_params[k]]["exp_avg"].shape[0]
             for k in ("w1", "b1", "w2")])
    os.environ["AUTODIST_ZERO"] = "1"
    runner = _matrix_session(4, None, AllReduce(), "adam")
    out["zero-env"] = np.array([runner.zero, runner.plan.zero])
    del os.environ["AUTODIST_ZERO"]


def _two_ranks(out, workdir: pathlib.Path):
    """The flagship under AutoDist()'s default builder and the checkpoints,
    on 2 ranks (PS along reduce = 2, Adam)."""
    import torch.distributed as dist
    rank = dist.get_rank()
    model = tlm.TransformerLM(_flag_config(tlm, torch.float32))
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "flag_params.npz").items()}
    step = AutoDist(resource_info=_nodes(2), device="cpu").function(
        tlm.make_loss_fn(model), params, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
        accumulation_steps=FLAG_ACCUM)
    out["flag-reduce"] = np.array(step.runner.plan.mesh_axes["reduce"])
    out["flag-losses"] = np.array([float(step(_tensors(b))) for b in flag_batches()])
    out["flag-sharded"] = np.array(sum(pl.sharded_update
                                       for pl in step.runner.layout.params.values()))
    for k, v in step.get_state().params.items():
        out[f"flag-param-{k}"] = v.detach().numpy().copy()

    ckpt = workdir / "ckpt"
    # The port's v2 write at step 3, then the uninterrupted steps to 5.
    runner = _matrix_session(2, None, PS(), "adam")
    state = runner.init(_tensors(matrix_params()))
    _steps(runner, state, 0, STEPS)
    Saver().save(state, str(ckpt / "port"))
    out["port-ckpt-v1"] = np.array(os.path.exists(ckpt / f"port-{STEPS}.npz"))
    Saver().save(state, str(ckpt / "gathered"), sharded=False)
    _record(out, "straight", runner, state, _steps(runner, state, STEPS, STEPS_TOTAL))
    # JAX's v2 and gather-on-save v1 at step 3 (the parent writes them),
    # restored into these ranks and continued to step 5.
    ready = workdir / "jax_ckpt_ready"
    for _ in range(600):
        if ready.exists():
            break
        time.sleep(0.1)
    for name in ("jaxv2", "jaxv1"):
        latest = Saver.latest_checkpoint(str(workdir / "jax_ckpt"), name=name)
        runner = _matrix_session(2, None, PS(), "adam")
        state = Saver().restore(latest, runner=runner)
        out[f"{name}-step"] = np.array(state.step)
        _record(out, name, runner, state, _steps(runner, state, STEPS, STEPS_TOTAL))
    # train() saving sharded, then resuming from it.
    for steps in (STEPS, STEPS_TOTAL):
        runner = _matrix_session(2, None, PS(), "adam")
        state = train(runner, _tensors(matrix_params()), lambda i: _tensors(matrix_batch(i)),
                      steps=steps, checkpoint_dir=str(ckpt), checkpoint_name="trainloop",
                      save_every=10_000, log_every=0)
    out["train-step"] = np.array(state.step)
    _record(out, "train", runner, state, [])
    if rank == 0:
        out["ckpt-files"] = np.array(sorted(os.listdir(ckpt)), dtype=str)


def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    out = {}
    _four_ranks(out)
    dist.destroy_process_group()
    if rank < 2:
        os.environ.update(WORLD_SIZE="2", MASTER_PORT=(workdir / "port2").read_text())
        join_gloo_group()
        _two_ranks(out, workdir)
        dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **out)


# ----------------------------------------------------------------- the JAX side

def _jax_runner(world, mesh, builder, optimizer, loss_fn, params, batch, zero=0,
                accumulation_steps=1):
    """The JAX package's runner on a mesh of its first ``world`` CPU devices."""
    import jax
    import autodist_tpu
    from autodist_tpu.model_spec import ModelSpec as JModelSpec
    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.plan import ShardingPlan as JPlan
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.runner import DistributedRunner as JRunner

    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=_nodes(world, mesh)), builder)
    spec = JModelSpec.from_loss_fn(loss_fn, params, batch)
    compiled = ad._compile(spec)
    plan = JPlan.from_strategy(compiled, spec)
    jmesh = build_mesh(axes=dict(plan.mesh_axes), devices=jax.devices()[:world])
    return JRunner(compiled, spec, loss_fn, optimizer, mesh=jmesh, plan=plan, zero=zero,
                   accumulation_steps=accumulation_steps)


def jax_matrix_loss(p, b):
    import jax.numpy as jnp
    rows = jnp.take(p["emb"], b["idx"], axis=0)
    h = rows + b["x"] @ p["wu"]
    pred = h @ p["w2"] + p["b"]
    return jnp.mean((b["y"] - pred) ** 2)


def jax_zero_loss(p, b):
    import jax.numpy as jnp
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((b["y"] - h @ p["w2"]) ** 2)


def _jax_optimizer(kind):
    import optax
    return optax.adam(1e-2) if kind == "adam" else optax.sgd(LR)


def _jax_run(runner, params, lo, hi, batch_fn=matrix_batch, state=None):
    import jax
    state = runner.init(params) if state is None else state
    losses = []
    for i in range(lo, hi):
        state, loss = runner.run(state, batch_fn(i))
        losses.append(float(loss))
    logical = from_jax_params(jax.device_get(runner.logical_params(state)))
    return state, losses, logical


@functools.cache
def jax_matrix(config):
    """``(runner, state, losses, logical params)`` of a JAX run of a
    matrix configuration on 4 devices."""
    builder, mesh, opt = MATRIX[config]
    runner = _jax_runner(4, mesh, _builder(builder, jax_package=True), _jax_optimizer(opt),
                         jax_matrix_loss, matrix_params(), matrix_batch(0))
    state, losses, logical = _jax_run(runner, matrix_params(), 0, STEPS)
    return runner, state, losses, logical


@functools.cache
def _max_grad():
    """G: the largest gradient element of the f32 model over the steps'
    batches (at the initial params)."""
    import jax
    g = [jax.grad(jax_matrix_loss)(matrix_params(), matrix_batch(i)) for i in range(STEPS)]
    return max(float(abs(np.asarray(x)).max()) for t in g for x in jax.tree_util.tree_leaves(t))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawn, started at once; calling the fixture waits for it. The
    JAX checkpoints the 2-rank phase restores are written meanwhile."""
    import jax
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    workdir = tmp_path_factory.mktemp("strategies")
    flat = {k: v.numpy() for k, v in from_jax_params(_flag_params()).items()}
    np.savez(workdir / "flag_params.npz", **flat)
    (workdir / "port2").write_text(str(_free_port()))
    with ranks_running(pathlib.Path(__file__), 4, "strategies", workdir,
                       timeout_s=SPAWN_TIMEOUT_S) as wait:
        from autodist_tpu.strategy import PS as JPS
        runner = _jax_runner(2, None, JPS(), _jax_optimizer("adam"), jax_matrix_loss,
                             matrix_params(), matrix_batch(0))
        state, _, _ = _jax_run(runner, matrix_params(), 0, STEPS)
        JSaver().save(state, str(workdir / "jax_ckpt" / "jaxv2"), runner=runner, sharded=True)
        JSaver().save(state, str(workdir / "jax_ckpt" / "jaxv1"), runner=runner,
                      sharded=False)
        (workdir / "jax_ckpt_ready").write_text("1")
        _, _, straight = _jax_run(runner, None, STEPS, STEPS_TOTAL,
                                  state=jax.tree_util.tree_map(lambda x: x, state))

        @functools.cache
        def results():
            wait()
            return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(4)], workdir, \
                straight

        yield results


@functools.cache
def _flag_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    return jax.device_get(jlm.init_params(_flag_config(jlm, np.float32),
                                          jax.random.PRNGKey(6))[1])


def _assert_params(got, prefix, want, atol=PARAM_ATOL):
    for key, value in want.items():
        np.testing.assert_allclose(got[f"{prefix}-param-{key}"], value.numpy(), atol=atol,
                                   rtol=0, err_msg=f"{prefix} {key}")


def _opt_shard_shapes(jstate, shape):
    """The shapes of the addressable shards of JAX's first Adam moment of
    the given shape."""
    import jax
    for leaf in jax.tree_util.tree_leaves(jstate.opt_state[0].mu):
        if tuple(leaf.shape) == shape:
            return sorted({tuple(s.data.shape) for s in leaf.addressable_shards})
    return None


# ---------------------------------------------------------------------- tests

@pytest.mark.parametrize("config", list(MATRIX))
def test_matrix_configuration_matches_jax(ranks, config):
    """Each JAX matrix configuration, 3 steps on 4 ranks against the JAX
    runner on 4 CPU devices: the losses and the logical params (bf16 wires
    within the derived bound), the same on every rank."""
    got, _, _ = ranks()
    _, _, losses, params = jax_matrix(config)
    atol, loss_tol = PARAM_ATOL, LOSS_TOL
    if config in BF16:
        atol += STEPS * LR * 2 ** -6 * _max_grad()
        loss_tol = dict(rtol=1e-2)
    for r in got:
        np.testing.assert_allclose(r[f"{config}-losses"], losses, **loss_tol)
        _assert_params(r, config, params, atol=atol)


@pytest.mark.parametrize("config", ["ps", "tp_zero", "partitioned", "par"])
def test_optimizer_state_is_sharded_as_jax_says(ranks, config):
    """Adam's moments of ``w2`` are physically this rank's shard of JAX's
    ``opt_pspec`` (``reduce`` under PS; ``model`` x ``reduce`` under
    tp_zero; the model shard under the partitioned plans)."""
    got, _, _ = ranks()
    _, jstate, _, _ = jax_matrix(config)
    want = _opt_shard_shapes(jstate, (DIM, DIM))
    assert sorted({tuple(r[f"{config}-w2-opt-shape"]) for r in got}) == want


@pytest.mark.parametrize("config", ["partitioned", "tp_zero", "par"])
def test_padded_storage_and_its_pad_stay_zero(ranks, config):
    """``wu`` (7 rows) is stored as 4-row shards of an 8-row padding on the
    2-way model axis, as JAX stores it; after the steps the pad row of the
    params and of both Adam moments is exactly 0."""
    import jax
    got, _, _ = ranks()
    _, jstate, _, _ = jax_matrix(config)
    assert tuple(jstate.params["wu"].shape) == (8, DIM)
    jparams = from_jax_params(jax.device_get(jstate.params), logical_shapes={"wu": (7, DIM)})
    assert tuple(jparams["wu"].shape) == (7, DIM)
    want = sorted({tuple(s.data.shape) for s in jstate.params["wu"].addressable_shards})
    assert sorted({tuple(r[f"{config}-wu-local-shape"]) for r in got}) == want == [(4, DIM)]
    for r in got:
        assert r[f"{config}-wu-storage"].shape == (8, DIM)
        np.testing.assert_array_equal(r[f"{config}-wu-storage"][7:], 0.0)
        np.testing.assert_array_equal(r[f"{config}-wu-moments"][:, 7:], 0.0)
        assert np.abs(r[f"{config}-wu-moments"][:, :7]).max() > 0
        np.testing.assert_allclose(r[f"{config}-wu-storage"][:7], jparams["wu"].numpy(),
                                   atol=PARAM_ATOL, rtol=0)


def test_parallax_wire_and_error_feedback(ranks):
    """Parallax with HorovodCompressorEF: the sparse wire carries ``emb``
    (its index leaf ``idx``, as JAX detects it), the dense params carry a
    per-rank bf16 residual, and each rank's residual is the JAX package's
    residual row of that data rank."""
    got, _, _ = ranks()
    runner, jstate, _, _ = jax_matrix("parallax")
    assert sorted(runner.plan.sparse_wire_params) == ["emb"]
    from autodist_tpu_torch.params import from_jax_compressor_state
    import jax
    bound = 2 ** -9 * 2 * _max_grad()
    for rank, r in enumerate(got):
        assert list(r["parallax-wire"]) == ["emb"] and r["parallax-explicit"]
        want = from_jax_compressor_state(jax.device_get(jstate.ef_state), data_index=rank)
        assert sorted(want) == sorted(k[len("parallax-ef-"):] for k in r
                                      if k.startswith("parallax-ef-")) == ["b", "w2", "wu"]
        for key, entry in want.items():
            np.testing.assert_allclose(r[f"parallax-ef-{key}"], entry["error"].numpy(),
                                       atol=bound, rtol=0, err_msg=key)
            assert np.abs(r[f"parallax-ef-{key}"]).max() > 0


def test_powersgd_warm_start_equals_jax(ranks):
    """PowerSGD's Q0 (a Threefry normal draw seeded by the name's CRC32,
    then QR) equals the JAX package's within 1e-6, on every rank."""
    got, _, _ = ranks()
    from autodist_tpu.parallel.synchronization import init_ef_state
    runner = jax_matrix("powersgd")[0]
    q0 = np.asarray(init_ef_state(runner.plan, matrix_params())["w2"].q)
    for r in got:
        np.testing.assert_allclose(r["powersgd-q0-w2"], q0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(synchronization.powersgd_q0("wu", (7, DIM), 2).numpy(),
                               np.asarray(init_ef_state(runner.plan, matrix_params())["wu"].q),
                               atol=1e-6, rtol=0)


def test_zero_update_matches_jax(ranks):
    """zero=1 under AllReduce on 4 data ranks (tests/test_dp_zero_update.py's
    model): Adam's moments hold a quarter of each leading dim, and the run
    equals JAX's zero=1 run and the port's own zero=0 run;
    ``AUTODIST_ZERO=1`` turns it on."""
    import optax
    from autodist_tpu.strategy import AllReduce as JAllReduce
    got, _, _ = ranks()
    runner = _jax_runner(4, None, JAllReduce(), optax.adam(1e-2), jax_zero_loss,
                         zero_params(), zero_batch(0), zero=1)
    assert runner.plan.zero
    _, losses, params = _jax_run(runner, zero_params(), 0, ZERO_STEPS, zero_batch)
    for r in got:
        assert list(r["zero1-opt-shapes"]) == [2, 4, 4]
        assert list(r["zero0-opt-shapes"]) == [8, 16, 16]
        assert list(r["zero-env"]) == [1, 1]
        for zero in (1, 0):
            np.testing.assert_allclose(r[f"zero{zero}-losses"], losses, **LOSS_TOL)
            _assert_params(r, f"zero{zero}", params)


def test_flagship_under_the_default_builder_matches_jax(ranks):
    """The flagship through ``AutoDist()`` with no builder, on 2 ranks:
    ``PSLoadBalancing`` along reduce = 2 with every tiling parameter's
    update sharded, 2-way accumulation and Adam, against the JAX package's
    default builder on 2 devices."""
    import jax.numpy as jnp
    import optax
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.strategy import PSLoadBalancing as JPSLB
    got, _, _ = ranks()
    jmodel = jlm.TransformerLM(_flag_config(jlm, jnp.float32))
    batches = flag_batches()
    runner = _jax_runner(2, None, JPSLB(), optax.adam(1e-3), jlm.make_loss_fn(jmodel),
                         _flag_params(), batches[0], accumulation_steps=FLAG_ACCUM)
    state = runner.init(_flag_params())
    losses = []
    for b in batches:
        state, loss = runner.run(state, b)
        losses.append(float(loss))
    import jax
    params = from_jax_params(jax.device_get(runner.logical_params(state)))
    for r in got[:2]:
        assert int(r["flag-reduce"]) == 2 and int(r["flag-sharded"]) > 10
        np.testing.assert_allclose(r["flag-losses"], losses, **LOSS_TOL)
        _assert_params(r, "flag", params)


def test_port_v2_checkpoint_restores_into_jax(ranks):
    """The port's 2-rank save of a sharded state is the v2 format (one
    shard file a rank, the manifest), and the JAX Saver restores it and
    continues to the port's uninterrupted params; the port's
    ``sharded=False`` save is v1 at the logical shapes."""
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    from autodist_tpu.strategy import PS as JPS
    got, workdir, straight = ranks()
    ckpt = workdir / "ckpt"
    files = list(got[0]["ckpt-files"])
    assert f"port-{STEPS}.shard00000-of-00002.npz" in files
    assert f"port-{STEPS}.shard00001-of-00002.npz" in files
    assert f"port-{STEPS}.json" in files and not got[0]["port-ckpt-v1"]
    runner = _jax_runner(2, None, JPS(), _jax_optimizer("adam"), jax_matrix_loss,
                         matrix_params(), matrix_batch(0))
    jstate = JSaver().restore(str(ckpt / f"port-{STEPS}"), runner=runner)
    assert int(jstate.step) == STEPS
    _, _, params = _jax_run(runner, None, STEPS, STEPS_TOTAL, state=jstate)
    for key, value in params.items():
        np.testing.assert_allclose(value.numpy(), got[0][f"straight-param-{key}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(straight[key].numpy(), value.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=key)
    with np.load(ckpt / f"gathered-{STEPS}.npz") as z:
        assert z["emb"].shape == (VOCAB, DIM) and z["__opt__/0/mu/emb"].shape == (VOCAB, DIM)
        flat = JSaver()._load_flat(str(ckpt / f"port-{STEPS}"))[0]
        for name in z.files:
            if name != "__step__":
                np.testing.assert_array_equal(z[name], flat[name], err_msg=name)


@pytest.mark.parametrize("name", ["jaxv2", "jaxv1"])
def test_jax_checkpoint_restores_into_port_ranks(ranks, name):
    """JAX's v2 write and its gather-on-save v1 of a PS state at step 3,
    restored into the port's 2 ranks (each placing its own shards),
    continue to JAX's uninterrupted params."""
    got, _, straight = ranks()
    for r in got[:2]:
        assert int(r[f"{name}-step"]) == STEPS
        _assert_params(r, name, straight)


def test_train_saves_sharded_and_resumes(ranks):
    """train() over 2 ranks under PS writes v2 checkpoints, and a second
    train() resumes from step 3 and reaches the uninterrupted params."""
    got, _, straight = ranks()
    files = list(got[0]["ckpt-files"])
    assert f"trainloop-{STEPS}.shard00001-of-00002.npz" in files
    assert f"trainloop-{STEPS_TOTAL}.json" in files
    for r in got[:2]:
        assert int(r["train-step"]) == STEPS_TOTAL
        _assert_params(r, "train", straight)


if __name__ == "__main__":
    if sys.argv[1] == "strategies":
        _worker(pathlib.Path(sys.argv[2]))
