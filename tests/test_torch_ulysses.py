"""The port's Ulysses sequence parallelism (autodist_tpu_torch.parallel.ulysses
and ``attention_impl="ulysses"``) against the JAX package's.

The port runs 4 gloo ranks, every case in one spawn: each child runs this
file as a script (``_worker``), imports torch and the port only, and writes
what it computed for the parent to compare. On the host the local attention
is flash's plain version. JAX is imported inside the test functions only
and runs as tests/test_sequence_parallel.py:168-216 runs it, on the 8-device
CPU mesh.

Everything is f32. Tolerances are the JAX package's own
(tests/test_sequence_parallel.py:171-216): the attention output atol 2e-5;
the sequence-parallel loss rtol 1e-5 and its gradients rtol 2e-4 / atol
2e-5 against the single-device dot model. The attention's input gradients
take the ring's 1e-4 (tests/test_attention.py:215-240: two summation
orders of f32 products).
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, SequenceParallel, from_jax_params
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import sequence, ulysses
from test_torch_ring_attention import join_gloo_group, ranks_running

RANKS, B, L, H, D = 4, 2, 32, 4, 8
SMALL = dict(vocab_size=128, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=32)
BATCH, SEQ = 4, 32
FOUR_GPUS = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
OUT = dict(rtol=0, atol=2e-5)
INPUT_GRAD = dict(rtol=1e-4, atol=1e-4)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _config(module, dtype, attention_impl):
    return module.TransformerLMConfig(**SMALL, dtype=dtype, tied_output=False,
                                      attention_impl=attention_impl)


def _qkv():
    rng = np.random.RandomState(0)
    return {n: rng.randn(B, L, H, D).astype(np.float32) for n in "qkv"}


def _tokens():
    rng = np.random.RandomState(3)
    return rng.randint(0, SMALL["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)


# ------------------------------------------------------------------ the ranks

def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    results = {}
    data = np.load(workdir / "qkv.npz")
    l_local = L // RANKS
    shard = slice(rank * l_local, (rank + 1) * l_local)
    q, k, v = (torch.tensor(data[n][:, shard], requires_grad=True) for n in "qkv")
    out = ulysses.ulysses_attention(q, k, v, causal=True, group=dist.group.WORLD)
    (out ** 2).sum().backward()
    for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        results[name] = t.detach().numpy()
    try:     # 3 heads on 4 ranks: raised before any exchange
        ulysses.ulysses_attention(q[:, :, :3], k[:, :, :3], v[:, :, :3],
                                  group=dist.group.WORLD)
        results["indivisible"] = np.array("no error")
    except ValueError as e:
        results["indivisible"] = np.array(str(e))

    # The training path at seq 2 on a data 2 x seq 2 mesh.
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    model = tlm.TransformerLM(_config(tlm, torch.float32, "ulysses"))
    ad = AutoDist(resource_info=FOUR_GPUS, strategy_builder=SequenceParallel(2),
                  device="cpu")
    runner = sequence.create_sequence_parallel_session(
        ad, model, params, lambda p: torch.optim.SGD(p, lr=0.1))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    batch = runner.shard_batch({"tokens": torch.tensor(np.load(workdir / "tokens.npy"))})
    grads, loss, _ = runner._grad_fn(leaves, batch)
    results["mesh"] = np.array(str(dict(runner.plan.mesh_axes)))
    results["loss"] = loss.detach().numpy()
    results.update({f"grad-{k}": g.numpy() for k, g in grads.items()})
    np.savez(workdir / f"ulysses_rank{rank}.npz", **results)
    dist.destroy_process_group()


@functools.cache
def _jax_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    cfg = _config(jlm, np.float32, "dot")
    return jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(2))[1])


@pytest.fixture(scope="module")
def ulysses_runs(tmp_path_factory):
    """The 4-rank run, started at once; calling it waits for the ranks and
    returns their results, rank by rank."""
    workdir = tmp_path_factory.mktemp("ulysses")
    np.savez(workdir / "qkv.npz", **_qkv())
    np.savez(workdir / "params.npz",
             **{k: v.numpy() for k, v in from_jax_params(_jax_params()).items()})
    np.save(workdir / "tokens.npy", _tokens())
    with ranks_running(pathlib.Path(__file__), RANKS, "ulysses", workdir) as wait:

        @functools.cache
        def results():
            wait()
            return [dict(np.load(workdir / f"ulysses_rank{r}.npz")) for r in range(RANKS)]

        yield results


def _joined(ranks, name):
    return np.concatenate([r[name] for r in ranks], axis=1)


def test_four_rank_attention_matches_jax_mesh(ulysses_runs):
    """Seq-sharded Ulysses over 4 ranks against JAX's on a {data: 2, seq: 4}
    mesh; its gradients against JAX's dot attention's."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models.transformer_lm import causal_mask, dot_product_attention
    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.ulysses import make_ulysses_attention_fn

    qkv = {n: jnp.asarray(a) for n, a in _qkv().items()}
    mesh = build_mesh(axes={"data": 2, "seq": 4})
    want = make_ulysses_attention_fn(mesh, causal=True)(qkv["q"], qkv["k"], qkv["v"])
    ranks = ulysses_runs()
    np.testing.assert_allclose(_joined(ranks, "out"), np.asarray(want), **OUT)

    def ref(q, k, v):
        out = dot_product_attention(q, k, v, causal_mask(L, jnp.float32), jnp.float32)
        return (out ** 2).sum()

    grads = jax.grad(ref, argnums=(0, 1, 2))(qkv["q"], qkv["k"], qkv["v"])
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_joined(ranks, name), np.asarray(g), err_msg=name,
                                   **INPUT_GRAD)


def test_indivisible_heads_raise(ulysses_runs):
    """3 heads on 4 seq ranks raise as the JAX package does, naming
    "divisible", on every rank (before any exchange, so no rank hangs)."""
    import jax.numpy as jnp
    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.ulysses import make_ulysses_attention_fn

    x = jnp.zeros((2, 32, 3, 8), jnp.float32)
    with pytest.raises(ValueError, match="divisible") as want:
        make_ulysses_attention_fn(build_mesh(axes={"data": 2, "seq": 4}))(x, x, x)
    for rank in ulysses_runs():
        assert str(rank["indivisible"]) == str(want.value)


def test_seq2_loss_and_grads_match_dot_model(ulysses_runs):
    """``attention_impl="ulysses"`` through ``create_sequence_parallel_session``
    with ``SequenceParallel(2)`` on a data 2 x seq 2 mesh: each rank's
    synchronized loss and gradients against JAX's single-device dot model
    (tests/test_sequence_parallel.py:187-206)."""
    import jax
    from autodist_tpu.models import transformer_lm as jlm

    jmodel = jlm.TransformerLM(_config(jlm, np.float32, "dot"))
    loss, grads = jax.value_and_grad(jlm.make_loss_fn(jmodel))(
        _jax_params(), {"tokens": _tokens()})
    want = from_jax_params(jax.device_get(grads))
    for rank in ulysses_runs():
        assert str(rank["mesh"]) == str({"data": 2, "reduce": 1, "model": 1, "seq": 2,
                                         "expert": 1, "pipe": 1})
        np.testing.assert_allclose(rank["loss"], float(loss), **LOSS)
        for key, g in want.items():
            np.testing.assert_allclose(rank[f"grad-{key}"], g.numpy(), err_msg=key, **GRAD)


def test_group_of_one_is_flash():
    """``seq_size == 1`` calls flash directly (ulysses.py:34-36)."""
    from autodist_tpu_torch.ops.flash_attention import flash_attention
    qkv = {n: torch.tensor(a) for n, a in _qkv().items()}
    out = ulysses.ulysses_attention(qkv["q"], qkv["k"], qkv["v"], causal=True)
    assert torch.equal(out, flash_attention(qkv["q"], qkv["k"], qkv["v"], causal=True))


if __name__ == "__main__":
    if sys.argv[1] == "ulysses":
        _worker(pathlib.Path(sys.argv[2]))
