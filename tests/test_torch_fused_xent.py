"""The port's fused LM-head loss (autodist_tpu_torch.ops.fused_xent) against
the JAX package's Pallas kernels, which run here in interpret mode as
tests/test_fused_xent.py runs them.

On CPU tensors the port's op takes its kernels' plain versions, so this pins
the arithmetic the CUDA kernels are held to on the card. Inputs are made with
numpy from a seed and fed to both packages; everything is f32, so the
tolerances are those of the JAX tests: 1e-5 for values, rtol 2e-4 / atol 2e-5
for gradients (two summation orders of f32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops import fused_xent as jfx
from autodist_tpu_torch.ops import fused_xent as tfx

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _data(n, d, v, seed=0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, d) * 0.5).astype(np.float32)
    w = (rng.randn(d, v) * 0.1).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    return h, w, b


def _stored(w, layout):
    return np.ascontiguousarray(w.T) if layout == "vd" else w


def _jax_lse_and_grads(h, w, b, layout, coef):
    def f(h, w, b):
        return jnp.sum(jfx.matmul_logsumexp(h, w, b, 64, 128, None, layout) * coef)

    args = [jnp.asarray(x) if x is not None else None for x in (h, w, b)]
    lse = jfx.matmul_logsumexp(*args, 64, 128, None, layout)
    argnums = (0, 1, 2) if b is not None else (0, 1)
    return np.asarray(lse), [np.asarray(g) for g in jax.grad(f, argnums)(*args)]


def _torch_lse_and_grads(h, w, b, layout, coef):
    ts = [torch.tensor(x, requires_grad=True) if x is not None else None
          for x in (h, w, b)]
    lse = tfx.matmul_logsumexp(*ts, w_layout=layout)
    (lse * torch.as_tensor(coef)).sum().backward()
    return lse.detach().numpy(), [t.grad.numpy() for t in ts if t is not None]


# The last two: the kernels' width, N one short of the forward's 128-row block
# with V one past its 128-column vocab tile, and N one past dh's 64-row block
# with V one past its 64-column tile (both V odd: the packed "dv" table pads).
@pytest.mark.parametrize("n,d,v", [(256, 128, 512), (200, 128, 384), (64, 64, 129),
                                   (127, 512, 129), (65, 512, 65)])
def test_lse_matches_jax(n, d, v):
    h, w, b = _data(n, d, v)
    want = jfx.matmul_logsumexp(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), 128, 256)
    got = tfx.matmul_logsumexp(torch.tensor(h), torch.tensor(w), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_lse_no_bias_matches_jax():
    h, w, _ = _data(128, 64, 320, seed=1)
    want = jfx.matmul_logsumexp(jnp.asarray(h), jnp.asarray(w), None, 64, 128)
    got = tfx.matmul_logsumexp(torch.tensor(h), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("layout", ["dv", "vd"])
@pytest.mark.parametrize("bias", [True, False])
def test_grads_match_jax(layout, bias):
    h, w, b = _data(192, 64, 300, seed=3)
    w = _stored(w, layout)
    b = b if bias else None
    coef = np.random.RandomState(4).rand(192).astype(np.float32) * 0.01
    lse_j, grads_j = _jax_lse_and_grads(h, w, b, layout, coef)
    lse_t, grads_t = _torch_lse_and_grads(h, w, b, layout, coef)
    np.testing.assert_allclose(lse_t, lse_j, **VAL)
    assert len(grads_t) == len(grads_j)
    for got, want in zip(grads_t, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **GRAD)


# The CUDA kernels' tiling edges at their one width, D = 512: the forward's
# blocks hold 128 rows and walk 128-column vocab tiles, dh's 64 rows and
# 64-column tiles; V odd is the packed "dv" table's padded stride.
@pytest.mark.parametrize("n,v,layout,bias", [(127, 129, "dv", True), (129, 129, "vd", False),
                                             (63, 65, "vd", True), (65, 65, "dv", False)])
def test_grads_at_kernel_tiling_edges_match_jax(n, v, layout, bias):
    h, w, b = _data(n, 512, v, seed=21)
    w = _stored(w, layout)
    b = b if bias else None
    coef = np.random.RandomState(22).rand(n).astype(np.float32) * 0.01
    lse_j, grads_j = _jax_lse_and_grads(h, w, b, layout, coef)
    lse_t, grads_t = _torch_lse_and_grads(h, w, b, layout, coef)
    np.testing.assert_allclose(lse_t, lse_j, **VAL)
    assert len(grads_t) == len(grads_j)
    for got, want in zip(grads_t, grads_j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize("layout", ["dv", "vd"])
def test_pack_w_plain_matches_jax_cast(layout):
    """The pack's plain version: w rounded to bf16 as the JAX kernels round
    each block (``w_ref[...].astype(h_ref.dtype)``), in its stored layout;
    "dv" rows padded with zeros to a multiple of 8 columns."""
    v = 131
    _, w, _ = _data(4, 512, v, seed=23)
    w = _stored(w, layout)
    got = tfx.pack_w_plain(torch.tensor(w), layout)
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    if layout == "vd":
        assert tuple(got.shape) == (v, 512)
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        assert tuple(got.shape) == (512, tfx.packed_cols(v)) == (512, 136)
        np.testing.assert_array_equal(got[:, :v].float().numpy(), want)
        assert not got[:, v:].float().any()
    assert tfx.packed_cols(136) == 136 and tfx.packed_cols(1) == 8


def test_large_bias_with_padding_rows_matches_jax():
    """Rows past a block edge and a bias entry > 88: dw and db stay finite
    and equal (tests/test_fused_xent.py:185)."""
    h, w, b = _data(100, 64, 256, seed=9)
    b[5] = 95.0
    coef = np.full(100, 1.0 / 100, np.float32)
    _, grads_j = _jax_lse_and_grads(h, w, b, "dv", coef)
    _, grads_t = _torch_lse_and_grads(h, w, b, "dv", coef)
    for got, want in zip(grads_t, grads_j):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize("layout", ["dv", "vd"])
def test_fused_softmax_xent_matches_jax(layout):
    n, d, v = 160, 64, 257
    h, w, b = _data(n, d, v, seed=5)
    w = _stored(w, layout)
    targets = np.random.RandomState(6).randint(0, v, (n,)).astype(np.int32)

    def jax_loss(h, w):
        return jnp.mean(jfx.fused_softmax_xent(h, w, jnp.asarray(targets), jnp.asarray(b),
                                               64, 128, w_layout=layout))

    want_nll = jfx.fused_softmax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(targets),
                                      jnp.asarray(b), 64, 128, w_layout=layout)
    want_grads = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))

    th, tw = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    nll = tfx.fused_softmax_xent(th, tw, torch.tensor(targets).long(), torch.tensor(b),
                                 w_layout=layout)
    nll.mean().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll), **VAL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_grads[0]), **GRAD)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_grads[1]), **GRAD)


@pytest.mark.parametrize("layout", ["dv", "vd"])
def test_plain_versions_chunk_invariant(layout):
    """The plain versions merge vocab chunks with a running logsumexp; a
    ragged chunking gives the one-chunk answer."""
    h, w, b = _data(48, 32, 300, seed=12)
    h, w, b = torch.tensor(h), torch.tensor(_stored(w, layout)), torch.tensor(b)
    g = torch.rand(48, generator=torch.Generator().manual_seed(0))
    whole = tfx.matmul_logsumexp_plain(h, w, b, layout, v_chunk=300)
    chunked = tfx.matmul_logsumexp_plain(h, w, b, layout, v_chunk=77)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **VAL)
    for got, want in zip(tfx.lse_backward_plain(h, w, b, whole, g, layout, v_chunk=77),
                         tfx.lse_backward_plain(h, w, b, whole, g, layout, v_chunk=300)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD)


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    h, w, b = (torch.tensor(x) for x in _data(32, 16, 40, seed=13))
    before = [k.launches for k in (*tfx.KERNELS, tfx.xent_pack_w)]
    lse = tfx.xent_fwd(h, w, b)
    g = torch.ones(32)
    dh = tfx.xent_dh(h, w, b, lse, g)
    dw, db = tfx.xent_dwdb(h, w, b, lse, g)
    wp = tfx.xent_pack_w(w)
    assert [k.launches for k in (*tfx.KERNELS, tfx.xent_pack_w)] == before
    assert wp.dtype == torch.bfloat16 and tuple(wp.shape) == (16, 40)
    assert dh.shape == h.shape and dw.shape == w.shape and db.shape == b.shape


def test_bad_layout_raises():
    h, w, b = (torch.tensor(x) for x in _data(8, 16, 20))
    with pytest.raises(ValueError, match="w_layout"):
        tfx.matmul_logsumexp(h, w, b, w_layout="dd")
    with pytest.raises(ValueError, match="is \\[N, 16\\]"):
        tfx.matmul_logsumexp(h, w.T.contiguous(), b, w_layout="dv")
