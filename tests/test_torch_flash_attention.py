"""The port's attention ops (autodist_tpu_torch.ops.{blockwise,flash}_attention)
against the JAX package's, whose Pallas flash kernels run here in interpret
mode as tests/test_attention.py runs them.

On CPU tensors the port's flash wrappers take their kernels' plain versions,
so this pins the arithmetic the CUDA kernels are held to on the card. Inputs
are made with numpy from a seed and fed to both packages; everything is f32,
so the tolerances are those of tests/test_attention.py: 2e-5 for outputs,
3e-4 for gradients (two summation orders of f32 products).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import blockwise_attention as tbw
from autodist_tpu_torch.ops import flash_attention as tfa

# autodist_tpu.ops re-exports functions under the modules' names.
jbw = importlib.import_module("autodist_tpu.ops.blockwise_attention")
jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

B, L, H, D = 2, 64, 4, 16
OUT = dict(rtol=1e-7, atol=2e-5)
GRAD = dict(rtol=1e-7, atol=3e-4)


def _qkv(seed=0, l=L, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, l, H, D).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,block,q_offset,k_offset",
                         [(True, 16, 0, 0), (False, 17, 0, 0), (True, 64, 0, 0),
                          (True, 16, 64, 0), (True, 16, 0, 32)])
def test_blockwise_matches_jax(causal, block, q_offset, k_offset):
    q, k, v = _qkv(1)
    kw = dict(causal=causal, block_size=block, q_offset=q_offset, k_offset=k_offset)
    want = jbw.blockwise_attention(*_j(q, k, v), **kw)
    got = tbw.blockwise_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


def test_blockwise_with_carry_matches_jax():
    """Two chained ring steps with global offsets, as the ring runs them: the
    query shard at offset L sees its own keys (offset L), then the previous
    shard's (offset 0); (acc, m, l) and the finalized output agree."""
    q, k1, v1 = _qkv(2)
    k2, v2 = _qkv(3, n=2)
    want = jbw.blockwise_attention_with_carry(*_j(q, k1, v1), None, block_size=16,
                                              q_offset=L, k_offset=L)
    want = jbw.blockwise_attention_with_carry(*_j(q, k2, v2), want, block_size=16,
                                              q_offset=L, k_offset=0)
    got = tbw.blockwise_attention_with_carry(*_t(q, k1, v1), None, block_size=16,
                                             q_offset=L, k_offset=L)
    got = tbw.blockwise_attention_with_carry(*_t(q, k2, v2), got, block_size=16,
                                             q_offset=L, k_offset=0)
    for a, b, name in zip(got, want, ("acc", "m", "l")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tbw.finalize(*got).numpy(),
                               np.asarray(jbw.finalize(*want)), **OUT)


@pytest.mark.parametrize("causal,l", [(True, L), (False, L), (True, 60)])
def test_flash_forward_matches_jax(causal, l):
    """Causal, not causal, and a ragged L = 60 against 32-blocks on the JAX
    side (its padding must not leak, nor does the port's lack of it)."""
    q, k, v = _qkv(4, l=l)
    want = jfa.flash_attention(*_j(q, k, v), causal=causal, q_block=32, k_block=32)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


def test_flash_lse_matches_jax():
    q, k, v = _qkv(5, l=60)
    _, want = jfa._flash_forward(*_j(q, k, v), True, 32, 32, True)  # [bh, n_q, 32]
    _, got = tfa.flash_forward_plain(*_t(q, k, v), causal=True)      # [bh, 60]
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B * H, -1)[:, :60],
                               **OUT)


def _jax_carry_lse(q, k, v, q_offset, k_offset):
    _, m, l = jbw.blockwise_attention_with_carry(*_j(q, k, v), None, block_size=16,
                                                 q_offset=q_offset, k_offset=k_offset)
    return np.asarray(m + jnp.log(jnp.maximum(l, 1e-30))).reshape(B * H, -1)


@pytest.mark.parametrize("q_offset,k_offset", [(64, 0), (0, 32)])
def test_flash_forward_offsets_match_jax(q_offset, k_offset):
    """Global offsets, as ring attention passes them; with k_offset = 32 the
    first 32 query rows see no key at all: their output is 0 (p = 0, not
    exp(0)) and their lse sits at NEG_INF."""
    q, k, v = _qkv(6)
    out, lse = tfa.flash_forward_plain(*_t(q, k, v), causal=True, q_offset=q_offset,
                                       k_offset=k_offset)
    want = jbw.blockwise_attention(*_j(q, k, v), causal=True, block_size=16,
                                   q_offset=q_offset, k_offset=k_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(lse.numpy(), _jax_carry_lse(q, k, v, q_offset, k_offset),
                               rtol=1e-6, atol=2e-5)
    if k_offset:
        assert not out[:, :k_offset].any()
        assert (lse.reshape(B, H, L)[:, :, :k_offset] <= tbw.NEG_INF * 0.5).all()


@pytest.mark.parametrize("l,causal,k_offset", [(129, True, 0), (129, False, 0),
                                               (193, True, 0), (256, True, 200)])
def test_flash_forward_at_kernel_tiling_edges_matches_jax(l, causal, k_offset):
    """The plain forward, the CUDA forward's oracle, at the edges of that
    kernel's tiling (192 query rows a block, 64 per consumer warpgroup, 128
    keys a tile): L one row past a 128- and a 192-row block, and k_offset
    200, where rows 0-199 see no key and the boundary falls inside a block.
    out and lse against the JAX Pallas forward (no offset) or the Pallas
    carry kernel from nothing, finalized (k_offset), in interpret mode."""
    q, k, v = _qkv(11, l=l)
    out, lse = tfa.flash_forward_plain(*_t(q, k, v), causal=causal, k_offset=k_offset)
    if k_offset == 0:
        want, want_lse = jfa._flash_forward(*_j(q, k, v), causal, 32, 32, True)
        want_lse = np.asarray(want_lse).reshape(B * H, -1)[:, :l]
    else:
        acc, m, l_ = jfa.flash_attention_with_carry(*_j(q, k, v), None, causal=causal,
                                                    k_offset=k_offset, q_block=32,
                                                    k_block=32)
        want = jnp.swapaxes(jbw.finalize(acc, m, l_), 1, 2)  # [B, H, L, D] -> [B, L, H, D]
        want_lse = np.asarray(m + jnp.log(jnp.maximum(l_, 1e-30))).reshape(B * H, -1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=2e-5)
    if k_offset:
        assert not out[:, :k_offset].any()


def _backward_plain_against_jax(seed, l, causal, q_offset, k_offset, out_dtype, block):
    """The plain backward against ``_flash_backward_kv`` (the two Pallas
    backward kernels, ``block`` rows a block on both sides) on the same q, k,
    v, dO, lse and D; returns the torch inputs and ``(dq, dk, dv)``."""
    q, k, v, do = _qkv(seed, l=l, n=4)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_forward_plain(tq, tk, tv, causal, q_offset, k_offset)
    dd = tfa.prepare_backward_q_side(out, tdo)
    got = tfa.flash_backward_plain(tq, tk, tv, tdo, lse, dd, causal, q_offset, k_offset,
                                   out_dtype=out_dtype)

    qf, dof, jdd, bq, n_q = jfa.prepare_backward_q_side(*_j(q, out.numpy(), do), block)
    np.testing.assert_allclose(dd.numpy(), np.asarray(jdd).reshape(B * H, -1)[:, :l], **OUT)
    # The Pallas kernels take lse in their padded [bh, n_q, bq] planes; pad
    # query rows have zero q and dO and contribute nothing.
    jlse = jnp.asarray(np.pad(lse.numpy(), ((0, 0), (0, n_q * bq - l)))).reshape(B * H, n_q, bq)
    want = jfa._flash_backward_kv(qf, dof, jlse, jdd, *_j(k, v), causal, bq, n_q, block, True,
                                  q.shape, q_offset=q_offset, k_offset=k_offset,
                                  out_dtype=jnp.float32 if out_dtype else None)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    return (tq, tk, tv, tdo, lse, dd), got


@pytest.mark.parametrize("q_offset,k_offset,out_dtype",
                         [(0, 0, None), (64, 0, torch.float32), (0, 32, torch.float32)])
def test_flash_backward_plain_matches_jax(q_offset, k_offset, out_dtype):
    """The plain backward against ``_flash_backward_kv`` (the two Pallas
    backward kernels) on the same q, k, v, dO, lse and D, with ring-style
    offsets and the f32 output override."""
    (tq, tk, tv, tdo, lse, dd), got = _backward_plain_against_jax(
        7, L, True, q_offset, k_offset, out_dtype, 32)
    # The split wrappers give the same three on CPU tensors.
    dk, dv = tfa.flash_bwd_dkdv(tq, tk, tv, tdo, lse, dd, True, q_offset, k_offset,
                                out_dtype)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, dd, True, q_offset, k_offset, out_dtype)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("l,causal,k_offset", [(129, True, 0), (129, False, 0),
                                               (193, True, 0), (193, False, 0),
                                               (256, True, 128)])
def test_flash_backward_plain_at_kernel_tiling_edges_matches_jax(l, causal, k_offset):
    """The plain backward, the CUDA backward kernels' oracle, at the edges of
    their tiling (64-row tiles; dK/dV blocks of 128 keys, dQ blocks of 192
    query rows): L one past a 128-key and a 192-row block, causal and not;
    and k_offset 128 at L = 256, where no query sees the second 128-key block
    and query rows 0-127 see no key, so their gradients are exactly 0."""
    _, (dq, dk, dv) = _backward_plain_against_jax(12, l, causal, 0, k_offset,
                                                  torch.float32, 64)
    if k_offset:
        assert not dq[:, :k_offset].any()
        assert not (dk[:, l - k_offset:].any() or dv[:, l - k_offset:].any())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_jax(causal):
    """Gradients through the port's autograd.Function against jax.grad
    through the JAX custom_vjp (its Pallas backward kernels)."""
    q, k, v = _qkv(8)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal, q_block=32,
                                           k_block=32) ** 2)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*_j(q, k, v))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (tfa.flash_attention(*ts, causal=causal) ** 2).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=f"d{name}",
                                   **GRAD)


def test_plain_versions_block_invariant():
    """The plain versions merge key blocks with an online softmax; a ragged
    blocking gives the one-block answer."""
    q, k, v, do = _t(*_qkv(9, n=4))
    whole = tfa.flash_forward_plain(q, k, v, True, k_block=L)
    ragged = tfa.flash_forward_plain(q, k, v, True, k_block=23)
    for a, b in zip(ragged, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5)
    dd = tfa.prepare_backward_q_side(whole[0], do)
    for a, b in zip(tfa.flash_backward_plain(q, k, v, do, whole[1], dd, k_block=23),
                    tfa.flash_backward_plain(q, k, v, do, whole[1], dd, k_block=L)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=3e-4)


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    q, k, v, do = _t(*_qkv(10, n=4))
    before = [kern.launches for kern in tfa.KERNELS]
    out, lse = tfa.flash_fwd(q, k, v)
    dd = tfa.prepare_backward_q_side(out, do)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse, dd)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, dd)
    assert [kern.launches for kern in tfa.KERNELS] == before
    assert out.shape == q.shape and lse.shape == (B * H, L)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_kernel_argument_checks():
    """What the CUDA wrappers refuse before launching (checked here on CPU
    tensors, which the wrappers themselves send to the plain versions)."""
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    q = bf(1, 8, 2, 64)
    with pytest.raises(TypeError, match="bf16"):
        tfa._check_kernel_args(q.float(), q, q)
    with pytest.raises(ValueError, match=r"head widths \(64, 128\), got 32"):
        tfa._check_kernel_args(*(bf(1, 8, 2, 32),) * 3)
    assert tfa._check_kernel_args(*(bf(1, 8, 2, 128),) * 3) == (1, 8, 8, 2, 128)
    with pytest.raises(ValueError, match="disagree"):
        tfa._check_kernel_args(q, bf(1, 8, 4, 64), bf(1, 8, 4, 64))
    with pytest.raises(ValueError, match="f32"):
        tfa._check_kernel_args(q, q, q, q, torch.zeros(2, 8), torch.zeros(2, 7))
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_args(q, q, q, bf(1, 2, 8, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="empty"):
        tfa._check_kernel_args(q, bf(1, 0, 2, 64), bf(1, 0, 2, 64))
    with pytest.raises(TypeError, match="bf16 or f32"):
        tfa._out_f32(torch.float16)
    assert tfa._check_kernel_args(q, bf(1, 5, 2, 64), bf(1, 5, 2, 64)) == (1, 8, 5, 2, 64)
