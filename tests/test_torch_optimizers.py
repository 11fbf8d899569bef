"""The port's optimizers (autodist_tpu_torch.optimizers) and their
checkpoints against the JAX package's optax ones.

- Adafactor against ``optax.adafactor(lr)`` at its defaults: 6 f32 steps
  whose first gradient is 10x, so the block-RMS clip acts, on the shapes
  where optax factors (``[3, 3, 128, 256]``, ``[512, 1024]``) and where it
  keeps a full second moment (``[64, 32]``, ``[4096, 64]``, ``[3, 3, 64,
  64]``: a second-largest dim under 128) and a 1-D tensor. The parameters
  must agree within 1e-6 of their largest magnitude (two summation orders of
  f32 means; the gap found is about 6e-8) and the state leaves too.
  ``torch.optim.Adafactor``, which factors the last two dims of every
  tensor, fails that bound on the unfactored shapes: the fault this module
  repairs.
- The same on 2 gloo ranks against the JAX single-device update: under
  ZeRO (``zero=1``: every parameter's update cut along its first even
  dim), under PS (the update cut along ``reduce``), and under
  ``UnevenPartitionedPS`` on a ``model`` axis of 2 (storage shards, the
  129-row parameter padded to 130, whose pad row must count in no mean);
  and those states' checkpoints (v1 and v2 of ZeRO's, v2 of the
  partitioned one) read by the JAX Saver. The ranks run this file as a
  script (torch and the port only).
- Checkpoints of Adafactor, SGD and SGD with momentum cross-load with the
  JAX Saver both ways, v1 and v2, bit for bit, and one more step on each
  side agrees (params atol 1e-6); a bf16 leaf in v1 is a ``V2`` array with
  ``"bfloat16"`` in the manifest, read back with the same bits both ways.
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.optimizers import Adafactor, Shard, state_shapes
from test_torch_ring_attention import join_gloo_group, ranks_running

LR = 1e-3
STEPS = 6
REL = 1e-6
SHAPES = [(64, 32), (4096, 64), (3, 3, 64, 64), (3, 3, 128, 256), (512, 1024), (1000,)]
UNFACTORED_2D = [(64, 32), (4096, 64), (3, 3, 64, 64)]
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
TWO = {"nodes": [{"address": "localhost", "gpus": [0, 1]}]}
# ZeRO over 2 ranks cuts each of these along its first even dim: a
# factored one along d1 and along d0 ([129, 256]), unfactored ones, 1-D.
ZERO_SHAPES = {"a": (256, 512), "b": (129, 256), "c": (64, 32), "d": (3, 3, 64, 64),
               "e": (1000,), "f": (3, 3, 128, 256)}
ZERO_ROWS = 8


def _rel(got, want) -> float:
    """max |got - want| over max |want| (the plain max |got - want| where
    want is all 0, as optax's placeholders are)."""
    gap = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = float(np.abs(want).max())
    return gap / scale if scale else gap


def _draws(shapes, seed=0):
    """f32 params and STEPS gradients per shape (the first one 10x)."""
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (10.0 if t == 0 else 1.0)
              for s in shapes] for t in range(STEPS)]
    return params, grads


@functools.cache
def _optax_run():
    """optax.adafactor over SHAPES: final params and the factored state."""
    import jax
    import jax.numpy as jnp
    import optax
    params, grads = _draws(SHAPES)
    tx = optax.adafactor(LR)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)

    @jax.jit
    def step(jp, state, g):
        updates, state = tx.update(g, state, jp)
        return optax.apply_updates(jp, updates), state

    for g in grads:
        jp, state = step(jp, state, [jnp.asarray(x) for x in g])
    fs = state[0]
    return ([np.asarray(p) for p in jp],
            {f: [np.asarray(x) for x in getattr(fs, f)] for f in ("v_row", "v_col", "v")},
            int(fs.count))


def _torch_run(make):
    params, grads = _draws(SHAPES)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make(tp)
    for g in grads:
        for t, x in zip(tp, g):
            t.grad = torch.tensor(x)
        opt.step()
    return [t.detach().numpy() for t in tp], opt, tp


@pytest.mark.parametrize("index", range(len(SHAPES)), ids=[str(s) for s in SHAPES])
def test_adafactor_matches_optax(index):
    """Params and optax's state leaves (names and shapes, placeholders
    included) after 6 steps, within 1e-6 of their largest magnitude."""
    want, want_state, want_count = _optax_run()
    got, opt, tp = _torch_run(lambda p: Adafactor(p, lr=LR))
    assert _rel(got[index], want[index]) <= REL
    st = opt.state[tp[index]]
    assert int(st["count"]) == want_count == STEPS
    assert st["count"] is opt.state[tp[0]]["count"]            # one count, shared
    for field in ("v_row", "v_col", "v"):
        assert tuple(st[field].shape) == want_state[field][index].shape \
            == state_shapes(SHAPES[index])[field], field
        assert _rel(st[field].numpy(), want_state[field][index]) <= REL, field


def test_torch_adafactor_is_not_optax():
    """The fault: ``torch.optim.Adafactor`` (what ``choose_optimizer`` handed
    out) misses the bound on every shape optax does not factor."""
    want = _optax_run()[0]
    got = _torch_run(lambda p: torch.optim.Adafactor(p, lr=LR))[0]
    for shape in UNFACTORED_2D:
        i = SHAPES.index(shape)
        assert _rel(got[i], want[i]) > 100 * REL, shape


def test_adafactor_pad_rows_count_in_no_mean():
    """A padded chunk (logical [100, 256] stored as [128, 256], zero pad
    rows and gradients) declared with its Shard takes optax's update of
    the logical tensor in its first 100 rows and leaves the pad rows, and
    their second moment, at 0."""
    import jax.numpy as jnp
    import optax
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((100, 256)).astype(np.float32) * 0.1
    gs = [rng.standard_normal((100, 256)).astype(np.float32) for _ in range(3)]
    tx = optax.adafactor(LR)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for g in gs:
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
    pad = torch.zeros(128, 256)
    pad[:100] = torch.tensor(p0)
    pad.requires_grad_()
    opt = Adafactor([pad], lr=LR)
    opt.shard(pad, Shard((100, 256), 0, 0, None))
    for g in gs:
        pad.grad = torch.zeros(128, 256)
        pad.grad[:100] = torch.tensor(g)
        opt.step()
    assert _rel(pad.detach()[:100].numpy(), np.asarray(jp)) <= REL
    assert not pad.detach()[100:].any() and not opt.state[pad]["v"][100:].any()


def test_adafactor_reduces_each_round_once(monkeypatch):
    """Each parameter declared a chunk (the whole of itself, cut along dim
    0, over a group of one): a step all-reduces the partial means of every
    parameter in three calls, one a round, and the update is the unsharded
    one (an all-reduce over one rank returns its input)."""
    from autodist_tpu_torch import optimizers
    calls = []
    monkeypatch.setattr(optimizers.dist, "all_reduce",
                        lambda t, group=None: calls.append((t.numel(), group)))
    group = object()
    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(2)]
    sides = []
    for declare in (False, True):
        ps = [torch.tensor(a, requires_grad=True) for a in p0]
        opt = Adafactor(ps, lr=LR)
        if declare:
            for t in ps:
                opt.shard(t, Shard(tuple(t.shape), 0, 0, group))
        for gs in grads:
            for t, g in zip(ps, gs):
                t.grad = torch.tensor(g)
            opt.step()
        sides.append([t.detach().numpy() for t in ps])
    assert len(calls) == 3 * len(grads) and all(g is group for _, g in calls)
    for got, want in zip(*reversed(sides)):
        assert _rel(got, want) <= REL


def test_unroll_sweep_under_adafactor_on_the_host():
    """``examples.benchmark.unroll --optimizer adafactor``: run_many equals
    run() bit for bit under the port's Adafactor, named in the metric."""
    from autodist_tpu_torch.examples.benchmark import unroll
    result = unroll.main(["--device", "cpu", "--factors", "1,2", "--steps", "4",
                          "--optimizer", "adafactor"])
    assert result["bit_identical"] is True and "adafactor" in result["metric"]


def test_adafactor_steps_on_meta_in_place():
    """plan_costs' probe: two steps on meta tensors, so a runner prices
    its update; on real ones every state tensor is updated in place (a
    captured graph holds them)."""
    metas = [torch.empty(s, device="meta", requires_grad=True) for s in SHAPES]
    opt = Adafactor(metas)
    for _ in range(2):
        for p in metas:
            p.grad = torch.empty_like(p)
        opt.step()
    _, opt, tp = _torch_run(lambda p: Adafactor(p, lr=LR))
    before = {(i, k): v for i, p in enumerate(tp) for k, v in opt.state[p].items()}
    for p in tp:
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(opt.state[tp[i]][k] is v for (i, k), v in before.items())
    assert _port_runner("adafactor")._update_cost().launches > 0


# ------------------------------------------------------------- ZeRO on 2 ranks

def _zero_consts():
    rng = np.random.default_rng(11)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in ZERO_SHAPES.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in ZERO_SHAPES.items()}
    h = {k: rng.standard_normal(s).astype(np.float32) for k, s in ZERO_SHAPES.items()}
    return params, g, h


def _zero_batch(i):
    rng = np.random.default_rng(100 + i)
    scale = 10.0 if i == 0 else 1.0
    return {"s": (rng.standard_normal(ZERO_ROWS) * scale).astype(np.float32),
            "t": rng.standard_normal(ZERO_ROWS).astype(np.float32)}


# (builder, mesh, session options) of the sharded runs.
SHARDED_RUNS = {"zero": ("AllReduce", None, {"zero": 1}),
                "ps": ("PS", None, {}),
                "partitioned": ("UnevenPartitionedPS", {"model": 2, "data": -1}, {})}


def _zero_worker(workdir: pathlib.Path):
    import torch.distributed as dist
    from autodist_tpu_torch import strategy
    join_gloo_group()
    rank = dist.get_rank()
    params, g, h = _zero_consts()
    gt = {k: torch.tensor(v) for k, v in g.items()}
    ht = {k: torch.tensor(v) for k, v in h.items()}

    def loss(p, b):
        terms = [(p[k] * gt[k]).sum() * b["s"] + (p[k] * ht[k]).sum() * b["t"] for k in p]
        return torch.stack(terms).sum(0).mean()

    out = {}
    for name, (builder, mesh, options) in SHARDED_RUNS.items():
        info = dict(TWO, mesh=mesh) if mesh else TWO
        ad = AutoDist(resource_info=info, strategy_builder=getattr(strategy, builder)(),
                      device="cpu")
        runner = ad.create_distributed_session(
            loss, {k: torch.tensor(v) for k, v in params.items()},
            lambda p: Adafactor(p, lr=LR), **options)
        state = runner.init({k: torch.tensor(v) for k, v in params.items()})
        for i in range(STEPS):
            runner.run(state, {k: torch.tensor(v) for k, v in _zero_batch(i).items()})
        out.update({f"{name}-param-{k}": v.detach().numpy().copy()
                    for k, v in runner.logical_params(state).items()})
        out[f"{name}-cut"] = np.array(sorted(k for k in params
                                             if runner.layout.update_chunk(k)[1]), dtype=str)
        saver = Saver()
        v2 = saver.save(state, str(workdir / name), sharded=True)
        if name == "zero":
            saver.save(state, str(workdir / "zerov1"), sharded=False)
        back = Saver().restore(v2, runner=runner)
        same = all(torch.equal(back.optimizer.state[back.opt_params[k]][f],
                               state.optimizer.state[state.opt_params[k]][f])
                   for k in params for f in ("v_row", "v_col", "v", "count"))
        out[f"{name}-restored"] = np.array(
            same and all(torch.equal(back.params[k], state.params[k]) for k in params))
    dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **out)


def _jax_zero():
    import jax
    import jax.numpy as jnp
    import optax
    params, g, h = _zero_consts()

    def loss(p, b):
        terms = [jnp.sum(p[k] * g[k]) * b["s"] + jnp.sum(p[k] * h[k]) * b["t"] for k in p]
        return jnp.mean(sum(terms))

    tx = optax.adafactor(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    @jax.jit
    def step(jp, state, b):
        updates, state = tx.update(jax.grad(loss)(jp, b), state, jp)
        return optax.apply_updates(jp, updates), state

    for i in range(STEPS):
        jp, state = step(jp, state, {k: jnp.asarray(v) for k, v in _zero_batch(i).items()})
    return {k: np.asarray(v) for k, v in jp.items()}, state[0]


def test_adafactor_zero_matches_jax_and_saves(tmp_path):
    """zero=1, PS and a padded model-axis partition over 2 ranks: the
    optimizer's tensors cut (every parameter under ZeRO and PS, the
    partitioned ones under the partitioner), the final params within 1e-6
    of optax's single-device ones on both ranks, each v2 restore bit for
    bit, and the checkpoints' Adafactor leaves (names, shapes) the JAX
    Saver reads within 1e-6 of optax's state."""
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    with ranks_running(pathlib.Path(__file__), 2, "zero", tmp_path) as wait:
        want, fstate = _jax_zero()
        wait()
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert sorted(got["zero-cut"]) == sorted(got["ps-cut"]) == sorted(ZERO_SHAPES)
        assert "b" in got["partitioned-cut"]                  # 129 rows over 2: padded
        for name in SHARDED_RUNS:
            assert bool(got[f"{name}-restored"]), name
            for k, v in want.items():
                assert _rel(got[f"{name}-param-{k}"], v) <= REL, (name, k)
    for prefix in ("zero-6", "zerov1-6", "partitioned-6"):
        flat, step = JSaver()._load_flat(str(tmp_path / prefix))
        assert step == STEPS and int(flat["__opt__/0/count"]) == STEPS
        for field in ("v_row", "v_col", "v"):
            for k in ZERO_SHAPES:
                leaf = np.asarray(flat[f"__opt__/0/{field}/{k}"])
                ref = np.asarray(getattr(fstate, field)[k])
                assert leaf.shape == ref.shape, (prefix, field, k)
                assert _rel(leaf, ref) <= REL, (prefix, field, k)
        for k, v in want.items():
            assert _rel(flat[k], v) <= REL


# ----------------------------------------------- checkpoints with the JAX Saver

CKPT_SHAPES = {"w": (256, 128), "emb": (64, 32), "b": (32,)}


def _ckpt_params():
    rng = np.random.default_rng(5)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in CKPT_SHAPES.items()}


def _ckpt_batch(i):
    rng = np.random.default_rng(200 + i)
    return {"x": rng.standard_normal((4, 64)).astype(np.float32),
            "z": rng.standard_normal((4, 256)).astype(np.float32),
            "y": rng.standard_normal((4, 32)).astype(np.float32)}


def _tloss(p, b):
    h = torch.tanh(b["x"] @ p["emb"] + p["b"])
    return ((h - b["y"]) ** 2).mean() + 0.1 * ((b["z"] @ p["w"]) ** 2).mean()


def _jloss(p, b):
    import jax.numpy as jnp
    h = jnp.tanh(b["x"] @ p["emb"] + p["b"])
    return jnp.mean((h - b["y"]) ** 2) + 0.1 * jnp.mean((b["z"] @ p["w"]) ** 2)


OPTIMIZERS = {
    "adafactor": (lambda p: Adafactor(p, lr=LR), lambda optax: optax.adafactor(LR)),
    "sgd": (lambda p: torch.optim.SGD(p, lr=0.05), lambda optax: optax.sgd(0.05)),
    "sgd_momentum": (lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
                     lambda optax: optax.sgd(0.05, momentum=0.9)),
}


def _port_runner(kind):
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=AllReduce(), device="cpu")
    return ad.create_distributed_session(_tloss, {k: torch.tensor(v)
                                                  for k, v in _ckpt_params().items()},
                                         OPTIMIZERS[kind][0])


@functools.cache
def _jax_trained(kind):
    """A JAX step function (its runner and, after 2 steps, its state)."""
    import autodist_tpu
    import optax
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import AllReduce as JAllReduce
    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE_GPU), JAllReduce())
    step = ad.function(_jloss, _ckpt_params(), OPTIMIZERS[kind][1](optax))
    for i in range(2):
        step(_ckpt_batch(i))
    return step


def _jax_leaves(state):
    from autodist_tpu.checkpoint.saver import _flatten_leaves
    import jax
    out = {k: np.asarray(v) for k, v in _flatten_leaves(jax.device_get(state.params)).items()}
    out.update({"__opt__/" + k: np.asarray(v) for k, v in
                _flatten_leaves(jax.device_get(state.opt_state)).items()})
    return out


def _port_leaves(prefix):
    flat, _ = Saver._load_flat(prefix)
    return {k: v.numpy() for k, v in flat.items()}


@pytest.mark.parametrize("sharded", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_checkpoint_cross_loads_with_jax(kind, sharded, tmp_path):
    """Port -> JAX: the JAX Saver restores the port's file into an optax
    state whose leaves equal the port's bit for bit. JAX -> port: the port
    restores JAX's file and saves it again with the same leaves. Then one
    more step on each side agrees."""
    import jax
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    runner = _port_runner(kind)
    state = runner.init({k: torch.tensor(v) for k, v in _ckpt_params().items()})
    for i in range(2):
        runner.run(state, _ckpt_batch(i))
    prefix = Saver().save(state, str(tmp_path / "port"), sharded=sharded)
    jstep = _jax_trained(kind)
    jstate = JSaver().restore(prefix, runner=jstep.runner)
    port = _port_leaves(prefix)
    jleaves = _jax_leaves(jstate)
    assert sorted(jleaves) == sorted(k for k in port if k != "__step__")
    for k, v in jleaves.items():
        np.testing.assert_array_equal(v, port[k], err_msg=k)
        assert v.dtype == port[k].dtype, k

    jprefix = JSaver().save(jstep.get_state(), str(tmp_path / "jax"), runner=jstep.runner,
                            sharded=sharded)
    back = Saver().restore(jprefix, runner=runner)
    again = _port_leaves(Saver().save(back, str(tmp_path / "again"), sharded=sharded))
    for k, v in _jax_leaves(jstep.get_state()).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)

    batch = _ckpt_batch(2)
    jstate, _ = jstep.runner.run(jax.tree_util.tree_map(lambda x: x, jstate), batch)
    runner.run(state, {k: torch.tensor(v) for k, v in batch.items()})
    jparams = jax.device_get(jstep.runner.logical_params(jstate))
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_bf16_leaf_in_v1_matches_the_jax_write(tmp_path):
    """A bf16 tensor in v1: the port writes what the JAX Saver writes (a
    ``V2`` array, "bfloat16" in the manifest); each package reads the
    other's file with the same bits (JAX's read gives ``V2``)."""
    import jax.numpy as jnp
    from autodist_tpu.checkpoint.saver import Saver as JSaver
    rng = np.random.default_rng(9)
    x = rng.standard_normal((37, 16)).astype(np.float32)
    t = torch.tensor(x).to(torch.bfloat16)
    port = Saver().save({"emb": t}, str(tmp_path / "port"))
    jax_prefix = JSaver().save({"emb": jnp.asarray(x, jnp.bfloat16)}, str(tmp_path / "jax"))
    bits = t.view(torch.int16).numpy().view(np.uint16)
    for prefix in (port, jax_prefix):
        with np.load(prefix + ".npz") as z:
            assert z["emb"].dtype == np.dtype("V2")
            np.testing.assert_array_equal(z["emb"].view(np.uint16), bits)
        assert json.load(open(prefix + ".json"))["params"]["emb"]["dtype"] == "bfloat16"
        got = Saver().restore_params(prefix)["emb"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, t)
        jgot = np.asarray(JSaver().restore(prefix)["emb"])
        np.testing.assert_array_equal(jgot.view(np.uint16), bits)


def test_unmapped_optimizers_still_refuse(tmp_path):
    """amsgrad, Nesterov and any other optimizer keep the refusal, which
    names the mapped set."""
    runner = _port_runner("sgd")
    state = runner.init({k: torch.tensor(v) for k, v in _ckpt_params().items()})
    params = list(state.params.values())
    for opt in (torch.optim.Adam(params, amsgrad=True),
                torch.optim.SGD(params, lr=0.1, momentum=0.9, nesterov=True),
                torch.optim.RMSprop(params)):
        state.optimizer = opt
        with pytest.raises(NotImplementedError, match="optax.adafactor"):
            Saver().save(state, str(tmp_path / "model"))


if __name__ == "__main__":
    if sys.argv[1] == "zero":
        _zero_worker(pathlib.Path(sys.argv[2]))
