"""Flash attention at head width 128 (the port's second instantiation of the
four flash kernels) against the JAX package, on the CPU.

On CPU tensors the port's flash wrappers take their kernels' plain
versions, the oracles the hd-128 CUDA kernels are held to on the card; the
JAX Pallas kernels run in interpret mode, as tests/test_attention.py runs
them, at d = 128 (``scale = 1/sqrt(128)`` on the f32 product). Inputs are
made with numpy from a seed; everything is f32, so the tolerances are
tests/test_torch_flash_attention.py's: 2e-5 for outputs and lse, 3e-4 for
gradients (two summation orders of f32 products), 1e-5 for the carry.

The long-context model at ``--d_model 1024`` (8 heads of 128, one layer,
seq 64, vocab 128, flash, remat, the fused head) through the port's entry
point's config, its loss against the JAX model's on the same weights (rtol
1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch import to_jax_params
from autodist_tpu_torch.ops import blockwise_attention as tbw
from autodist_tpu_torch.ops import flash_attention as tfa

jbw = importlib.import_module("autodist_tpu.ops.blockwise_attention")
jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

B, H, D = 1, 2, 128
OUT = dict(rtol=1e-7, atol=2e-5)
GRAD = dict(rtol=1e-7, atol=3e-4)
CARRY = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, l, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, l, H, D).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,l", [(True, 64), (False, 64), (True, 72)])
def test_forward_plain_matches_jax_at_hd128(causal, l):
    """out and lse of the plain forward against the Pallas forward (32-row
    blocks; L = 72 ragged against them)."""
    q, k, v = _qkv(1, l)
    want, want_lse = jfa._flash_forward(*_j(q, k, v), causal, 32, 32, True)
    out, lse = tfa.flash_fwd(*_t(q, k, v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(B * H, -1)[:, :l],
                               **OUT)


@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (64, 0), (0, 32)])
def test_carry_plain_matches_jax_at_hd128(q_offset, k_offset):
    """Two chained ring steps through the carry wrapper against the Pallas
    carry kernel; with k_offset 32 the first 32 rows see no key."""
    q, k1, v1 = _qkv(2, 64)
    k2, v2 = _qkv(3, 64, n=2)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    want = jfa.flash_attention_with_carry(*_j(q, k1, v1), None, q_block=32, k_block=32, **kw)
    want = jfa.flash_attention_with_carry(*_j(q, k2, v2), want, q_block=32, k_block=32, **kw)
    got = tfa.flash_attention_with_carry(*_t(q, k1, v1), None, **kw)
    got = tfa.flash_attention_with_carry(*_t(q, k2, v2), got, **kw)
    for a, b, name in zip(got, want, ("acc", "m", "l")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **CARRY)
    np.testing.assert_allclose(tbw.finalize(*got).numpy(), np.asarray(jbw.finalize(*want)),
                               **OUT)


@pytest.mark.parametrize("l,causal,q_offset,k_offset",
                         [(64, True, 0, 0), (72, False, 0, 0), (64, True, 64, 0),
                          (64, True, 0, 32)])
def test_backward_plain_matches_jax_at_hd128(l, causal, q_offset, k_offset):
    """dq, dk and dv of the plain backward (the dK/dV and dQ wrappers on
    CPU tensors, f32 outputs) against the two Pallas backward kernels on the
    same q, k, v, dO, lse and D."""
    q, k, v, do = _qkv(4, l, n=4)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_fwd(tq, tk, tv, causal, q_offset, k_offset)
    dd = tfa.prepare_backward_q_side(out, tdo)
    dk, dv = tfa.flash_bwd_dkdv(tq, tk, tv, tdo, lse, dd, causal, q_offset, k_offset,
                                torch.float32)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, dd, causal, q_offset, k_offset,
                          torch.float32)
    block = 32
    qf, dof, jdd, bq, n_q = jfa.prepare_backward_q_side(*_j(q, out.numpy(), do), block)
    jlse = jnp.asarray(np.pad(lse.numpy(), ((0, 0), (0, n_q * bq - l)))).reshape(B * H, n_q, bq)
    want = jfa._flash_backward_kv(qf, dof, jlse, jdd, *_j(k, v), causal, bq, n_q, block, True,
                                  q.shape, q_offset=q_offset, k_offset=k_offset,
                                  out_dtype=jnp.float32)
    for a, b, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    if k_offset:
        assert not dq[:, :k_offset].any()


def test_gradients_through_the_function_match_jax_at_hd128():
    """jax.grad through the JAX custom_vjp against the port's autograd
    Function, whose CPU path runs the plain versions, and no hd-128 kernel
    launch is counted on the CPU."""
    q, k, v = _qkv(5, 64)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True, q_block=32, k_block=32) ** 2)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*_j(q, k, v))
    before = [c.launches for c in tfa.KERNELS + tfa.KERNELS_HD128]
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (tfa.flash_attention(*ts, causal=True) ** 2).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD)
    assert [c.launches for c in tfa.KERNELS + tfa.KERNELS_HD128] == before
    assert [c.__name__ for c in tfa.KERNELS_HD128] == [
        "flash_fwd_hd128", "flash_fwd_carry_hd128", "flash_bwd_hd128"]


def test_long_context_model_at_d1024_matches_jax():
    """The entry point's config at ``--d_model 1024`` (head width 128), one
    layer, seq 64, vocab 128: the port's loss against the JAX model's on
    the port's initial weights."""
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu_torch.examples import long_context_lm as lc
    from autodist_tpu_torch.models import transformer_lm as tlm
    args = lc.parse_args(["--device", "cpu", "--d_model", "1024", "--n_layers", "1",
                          "--seq_len", "64", "--vocab", "128", "--batch_size", "2"])
    cfg = lc.model_config(args)
    assert cfg.d_model // cfg.n_heads == 128 and cfg.attention_impl == "flash" and cfg.remat
    model, params = tlm.init_params(cfg, seed=0, device="cpu")
    batch = tlm.synthetic_batch(cfg, 2, 64, seed=4)
    got = float(tlm.make_loss_fn(model)(params, {k: torch.tensor(v) for k, v in batch.items()}))
    jcfg = jlm.TransformerLMConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, max_len=cfg.max_len, dtype=jnp.float32,
        tied_output=False, remat=True, attention_impl="flash", fused_head=True)
    want = jax.jit(jlm.make_loss_fn(jlm.TransformerLM(jcfg)))(
        to_jax_params(params), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
