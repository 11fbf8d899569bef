"""The port's ring attention (autodist_tpu_torch.parallel.ring_attention) and
its local step, the flash carry (autodist_tpu_torch.ops.flash_attention),
against the JAX package's.

On CPU tensors the carry wrapper takes its kernel's plain version, so this
pins the arithmetic the CUDA carry kernel is held to on the card. Inputs are
made with numpy from a seed and fed to both packages; everything is f32.
JAX runs as tests/test_attention.py runs it: Pallas in interpret mode, the
ring inside ``shard_map`` on the 8-device CPU mesh ({seq: 4, data: 2}), and
is imported inside the test functions only.

The port's multi-rank ring runs in 4 processes over gloo, all cases in one
spawn: each child runs this file as a script (``_worker``), imports torch
and the port only, and writes its shard's results for the parent to
compare. Every process group has an init timeout and the spawn a time
limit, so a hang fails in seconds.

Tolerances: the carry 1e-5 (atol and rtol, the JAX package's own carry test,
tests/test_attention.py:182-212); the ring's output and gradients 1e-4
(tests/test_attention.py:215-240, two summation orders of f32 products over
four ring steps).
"""

import contextlib
import functools
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import blockwise_attention as tbw
from autodist_tpu_torch.ops import flash_attention as tfa
from autodist_tpu_torch.parallel import ring_attention as tra

REPO = pathlib.Path(__file__).resolve().parents[1]
CARRY = dict(rtol=1e-5, atol=1e-5)
RING = dict(rtol=1e-4, atol=1e-4)
RING_RANKS, RING_B, RING_L, RING_H, RING_D, RING_BLOCK = 4, 2, 64, 2, 8, 16
RING_CASES = [(impl, causal) for impl in ("flash", "blockwise") for causal in (True, False)]
SPAWN_TIMEOUT_S = 120


# ------------------------------------------------------------ multi-rank spawn

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def ranks_running(script: pathlib.Path, world: int, mode: str, workdir: pathlib.Path,
                  timeout_s: float = SPAWN_TIMEOUT_S):
    """Start ``python script mode workdir`` as ``world`` ranks with torchrun's
    environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and
    yield ``wait()``, which returns their outputs once they are done (the
    caller works meanwhile). ``wait`` fails the test when a rank exits
    non-zero or the ranks are not done within ``timeout_s``; ranks still
    running on exit are killed."""
    port = _free_port()
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(script), mode, str(workdir)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s

    @functools.cache
    def wait():
        try:
            logs = [proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                    for proc in procs]
        except subprocess.TimeoutExpired:
            pytest.fail(f"{mode}: {world} ranks not done in {timeout_s} s")
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            assert proc.returncode == 0, \
                f"{mode} rank {rank} exited {proc.returncode}:\n{log[-4000:]}"
        return logs

    try:
        yield wait
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def join_gloo_group():
    """In a child: one thread, and the default group from the environment
    through the port's own bootstrap (gloo on the host, with a timeout)."""
    from autodist_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    assert multihost.maybe_initialize_multihost(torch.device("cpu"), timeout_s=60)


def _ring_worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    rank = dist.get_rank()
    data = np.load(workdir / "ring_inputs.npz")
    l_local = RING_L // RING_RANKS
    shard = slice(rank * l_local, (rank + 1) * l_local)
    results = {}
    for impl, causal in RING_CASES:
        q, k, v = (torch.tensor(data[n][:, shard], requires_grad=True) for n in "qkv")
        out = tra.ring_attention(q, k, v, causal=causal, group=dist.group.WORLD,
                                 block_size=RING_BLOCK, impl=impl)
        (out ** 2).sum().backward()
        for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            results[f"{impl}-{causal}-{name}"] = t.detach().numpy()
    np.savez(workdir / f"ring_rank{rank}.npz", **results)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every case of the 4-rank ring in one spawn, started at once:
    ``(inputs, results)``, where ``results()`` waits for the ranks and
    returns ``{key: array over the whole sequence}``, the shards joined in
    ring order."""
    workdir = tmp_path_factory.mktemp("ring")
    rng = np.random.RandomState(1)
    inputs = {n: rng.randn(RING_B, RING_L, RING_H, RING_D).astype(np.float32) for n in "qkv"}
    np.savez(workdir / "ring_inputs.npz", **inputs)
    with ranks_running(pathlib.Path(__file__), RING_RANKS, "ring", workdir) as wait:

        @functools.cache
        def results():
            wait()
            shards = [np.load(workdir / f"ring_rank{r}.npz") for r in range(RING_RANKS)]
            return {key: np.concatenate([s[key] for s in shards], axis=1)
                    for key in shards[0].files}

        yield inputs, results


# ------------------------------------------------------------------- tests

def _carry_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(2, 32, 2, 8).astype(np.float32) for _ in range(5)]


@pytest.mark.parametrize("reference", ["flash", "blockwise"])
def test_carry_matches_jax_over_two_ring_steps(reference):
    """Two chained steps with global offsets, as the ring runs them: the
    query shard at offset 32 sees its own keys (offset 32), then the
    previous shard's (offset 0); (acc, m, l) agree with the JAX Pallas carry
    kernel and with its blockwise carry."""
    import importlib

    import jax.numpy as jnp

    # autodist_tpu.ops re-exports functions under the modules' names.
    jbw = importlib.import_module("autodist_tpu.ops.blockwise_attention")
    jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

    q, k1, v1, k2, v2 = _carry_inputs()
    lq = q.shape[1]
    j = [jnp.asarray(x) for x in (q, k1, v1, k2, v2)]
    if reference == "flash":
        step = lambda qq, kk, vv, c, qo, ko: jfa.flash_attention_with_carry(  # noqa: E731
            qq, kk, vv, c, causal=True, q_offset=qo, k_offset=ko, q_block=16, k_block=16)
    else:
        step = lambda qq, kk, vv, c, qo, ko: jbw.blockwise_attention_with_carry(  # noqa: E731
            qq, kk, vv, c, causal=True, block_size=16, q_offset=qo, k_offset=ko)
    want = step(j[0], j[1], j[2], None, lq, lq)
    want = step(j[0], j[3], j[4], want, lq, 0)

    t = [torch.tensor(x) for x in (q, k1, v1, k2, v2)]
    got = tfa.flash_attention_with_carry(t[0], t[1], t[2], causal=True, q_offset=lq,
                                         k_offset=lq)
    got = tfa.flash_attention_with_carry(t[0], t[3], t[4], got, causal=True, q_offset=lq,
                                         k_offset=0)
    for a, b, name in zip(got, want, ("acc", "m", "l")):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **CARRY)
    np.testing.assert_allclose(tbw.finalize(*got).numpy(),
                               np.asarray(jbw.finalize(*want)), **CARRY)


def test_carry_passes_rows_without_keys_through_unchanged():
    """A step whose keys all lie in the queries' future leaves the carry
    bit for bit as it was (the kernel's pass-through blocks), and a step
    from nothing equals the plain forward once finalized."""
    q, k1, v1, k2, v2 = (torch.tensor(x) for x in _carry_inputs())
    carry = tfa.flash_forward_carry_plain(q, k1, v1, None, True, 0, 0)
    after = tfa.flash_fwd_carry(q, k2, v2, carry, True, q_offset=0, k_offset=32)
    for a, b in zip(after, carry):
        assert torch.equal(a, b)
    out, lse = tfa.flash_forward_plain(q, k1, v1, True)
    torch.testing.assert_close(tbw.finalize(*carry).transpose(1, 2), out)
    torch.testing.assert_close(carry[1] + torch.log(carry[2]), lse.reshape(carry[1].shape))


def test_carry_wrapper_takes_the_plain_version_on_the_cpu_and_checks_the_carry():
    q, k1, v1, _, _ = (torch.tensor(x) for x in _carry_inputs())
    before = tfa.flash_fwd_carry.launches
    tfa.flash_fwd_carry(q, k1, v1)
    assert tfa.flash_fwd_carry.launches == before
    assert tfa.flash_fwd_carry in tfa.KERNELS
    acc, m, l = tfa.flash_forward_carry_plain(q, k1, v1)
    with pytest.raises(ValueError, match="carry acc must be f32"):
        tfa._check_carry((acc.double(), m, l), 2, 2, 32, 8, q.device)
    with pytest.raises(ValueError, match="carry l must be f32"):
        tfa._check_carry((acc, m, l[..., :5]), 2, 2, 32, 8, q.device)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_carry((acc, m.transpose(1, 2).contiguous().transpose(1, 2), l),
                         2, 2, 32, 8, q.device)


@pytest.mark.parametrize("impl", ["flash", "blockwise", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_ring_is_flash_attention(impl, causal):
    """A ring of one rank (no group) is plain attention over the local shard,
    forward and gradients."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(2, 40, 2, 16).astype(np.float32), requires_grad=True)
               for _ in range(3))
    got = tra.ring_attention(q, k, v, causal=causal, group=None, block_size=16, impl=impl)
    g_got = torch.autograd.grad((got ** 2).sum(), (q, k, v))
    want = tfa.flash_attention(q, k, v, causal=causal)
    g_want = torch.autograd.grad((want ** 2).sum(), (q, k, v))
    torch.testing.assert_close(got, want, **CARRY)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="impl"):
        tra.ring_attention(q, k, v, impl="ulysses")


@pytest.mark.parametrize("impl,causal", RING_CASES)
def test_four_rank_ring_matches_jax_ring(ring_runs, impl, causal):
    """The port's ring over 4 gloo ranks against the JAX ring on the CPU
    mesh ({seq: 4, data: 2}): the output and the gradients of
    ``sum(out ** 2)`` over the whole sequence."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from autodist_tpu.parallel.mesh import build_mesh
    from autodist_tpu.parallel.ring_attention import ring_attention

    inputs, results = ring_runs
    mesh = build_mesh(axes={"seq": 4, "data": 2})
    spec = P(("data", "reduce"), "seq", None, None)
    fn = jax.shard_map(
        lambda q, k, v: ring_attention(q, k, v, causal=causal, block_size=RING_BLOCK,
                                       impl=impl),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    def loss(*qkv):
        out = fn(*qkv)
        return jnp.sum(out ** 2), out

    # One jit for the output and the gradients: a fraction of eager shard_map's time.
    args = [jnp.asarray(inputs[n]) for n in "qkv"]
    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                     has_aux=True))(*args)
    got = results()
    for name, want in zip(("out", "dq", "dk", "dv"), (out, *grads)):
        np.testing.assert_allclose(got[f"{impl}-{causal}-{name}"], np.asarray(want),
                                   err_msg=name, **RING)


if __name__ == "__main__":
    if sys.argv[1] == "ring":
        _ring_worker(pathlib.Path(sys.argv[2]))
