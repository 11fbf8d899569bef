"""The flash backward's one wrapper, ``flash_bwd`` (dq, dk and dv in one
call: the dK/dV and dQ kernels at head width 64, the one-pass kernel at
128), against the JAX package's backward on the CPU.

On CPU tensors ``flash_bwd`` takes the plain version, the oracle the CUDA
kernels are held to on the card; the JAX Pallas backward kernels run in
interpret mode (``_flash_backward_kv``, the custom VJP's backward, and
``jax.grad`` through ``flash_attention``), as tests/test_attention.py runs
them. Inputs are made with numpy from a seed, B * H = 2, L <= 300 (ragged
against the kernels' 64-row tiles and the Pallas 64-row blocks); everything
is f32, so the tolerances are tests/test_torch_flash_attention.py's: 3e-4
for gradients (two summation orders of f32 products), 2e-5 for outputs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import flash_attention as tfa
from autodist_tpu_torch.parallel import ring_attention as tra

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

B, H = 1, 2
L = 300
BLOCK = 64
GRAD = dict(rtol=1e-7, atol=3e-4)


def _qkv(seed, l, d, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, l, H, d).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_backward(q, k, v, do, out, lse, causal, q_offset, k_offset, out_dtype):
    """dq, dk and dv of the Pallas backward kernels on the same q, k, v, dO,
    lse and D."""
    l = q.shape[1]
    qf, dof, jdd, bq, n_q = jfa.prepare_backward_q_side(*_j(q, out, do), BLOCK)
    jlse = jnp.asarray(np.pad(lse, ((0, 0), (0, n_q * bq - l)))).reshape(B * H, n_q, bq)
    return jfa._flash_backward_kv(qf, dof, jlse, jdd, *_j(k, v), causal, bq, n_q, BLOCK, True,
                                  q.shape, q_offset=q_offset, k_offset=k_offset,
                                  out_dtype=out_dtype)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,q_offset,k_offset,out_dtype",
                         [(True, 0, 0, None), (False, 0, 0, None), (True, 1024, 0, None),
                          (True, 0, 300, torch.float32), (True, 0, 100, torch.float32)])
def test_flash_bwd_matches_jax(d, causal, q_offset, k_offset, out_dtype):
    """dq, dk and dv of ``flash_bwd`` against the Pallas backward; with
    k_offset 300 no query sees a key, with 100 rows 0-99 see none, and
    those rows' dq, and the keys no query sees, are exactly 0."""
    q, k, v, do = _qkv(21 + d, L, d)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_fwd(tq, tk, tv, causal, q_offset, k_offset)
    dd = tfa.prepare_backward_q_side(out, tdo)
    got = tfa.flash_bwd(tq, tk, tv, tdo, lse, dd, causal, q_offset, k_offset, out_dtype)
    want = _jax_backward(q, k, v, do, out.numpy(), lse.numpy(), causal, q_offset, k_offset,
                         jnp.float32 if out_dtype else None)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and a.shape == tq.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    blind = min(L, max(0, k_offset - q_offset)) if causal else 0
    unseen = min(L, max(0, q_offset - k_offset + L)) if causal else L
    dq, dk, dv = got
    assert not dq[:, :blind].any()
    assert not (dk[:, unseen:].any() or dv[:, unseen:].any())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_equals_the_pair_on_the_cpu(d):
    """On CPU tensors ``flash_bwd`` gives what the dK/dV and dQ wrappers
    give, bit for bit, and no wrapper counts a launch."""
    tq, tk, tv, tdo = _t(*_qkv(3, 130, d))
    out, lse = tfa.flash_fwd(tq, tk, tv)
    dd = tfa.prepare_backward_q_side(out, tdo)
    before = [c.launches for c in tfa.KERNELS + tfa.KERNELS_HD128]
    dq, dk, dv = tfa.flash_bwd(tq, tk, tv, tdo, lse, dd)
    assert [c.launches for c in tfa.KERNELS + tfa.KERNELS_HD128] == before
    pair_dk, pair_dv = tfa.flash_bwd_dkdv(tq, tk, tv, tdo, lse, dd)
    pair_dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, dd)
    for a, b in zip((dq, dk, dv), (pair_dq, pair_dk, pair_dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _spy(monkeypatch, module):
    """Count the calls of ``module.flash_bwd`` (the name each caller uses)."""
    calls = []
    real = tfa.flash_bwd

    def spy(*args, **kwargs):
        calls.append(args[0].shape[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "flash_bwd", spy)
    return calls


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("path", ["flash_attention", "ring"])
def test_backward_paths_go_through_flash_bwd(monkeypatch, d, path):
    """``_FlashAttention.backward`` and the flash ring's backward (a ring of
    one rank here) call ``flash_bwd`` once, and their gradients match
    ``jax.grad`` through the JAX custom VJP."""
    q, k, v = _qkv(5, 130, d, n=3)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True, q_block=BLOCK,
                                           k_block=BLOCK) ** 2)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*_j(q, k, v))
    calls = _spy(monkeypatch, tfa if path == "flash_attention" else tra)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    if path == "flash_attention":
        out = tfa.flash_attention(*ts, causal=True)
    else:
        out = tra.ring_attention(*ts, causal=True, group=None, impl="flash")
    (out ** 2).sum().backward()
    assert calls == [d]
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD)


def test_flash_bwd_names_its_kernel():
    """The one-pass kernel counts its launches apart, among the hd-128
    kernels the launch checks read."""
    assert tfa.flash_bwd.hd128 in tfa.KERNELS_HD128
    assert tfa.flash_bwd.hd128.__name__ == "flash_bwd_hd128"


def test_pair_refuses_head_width_128_naming_flash_bwd():
    """On the card the backward pair exists at head width 64 only: at 128
    its wrappers raise, naming the one-pass wrapper."""
    tfa._pair_width(64)
    with pytest.raises(ValueError, match="flash_bwd computes dq, dk and dv"):
        tfa._pair_width(128)
