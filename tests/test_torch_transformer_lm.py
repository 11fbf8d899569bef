"""The port's TransformerLM against the flax model, with one set of weights
fed to both through ``from_jax_params``.

The model runs in f32 on both sides, so the only differences are the two
frameworks' f32 summation orders: hidden states and logits agree to rtol 1e-4 /
atol 1e-5, losses to rtol 1e-5. Separate tests pin the flax conventions that
a torch default would silently change (LayerNorm eps and statistics, tanh
GELU, the additive mask) and the bf16 compute path.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu_torch import from_jax_params, to_jax_params
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.ops import flash_attention as tfa

SMALL = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32)
ACT = dict(rtol=1e-4, atol=1e-5)


@functools.cache
def _jax_params(tied):
    """One flax init per head kind (the tree does not depend on the dtype
    or on fused_head), as numpy arrays."""
    cfg = jlm.TransformerLMConfig(**SMALL, tied_output=tied, dtype=jnp.float32)
    return jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(3))[1])


def _pair(tied, fused_head, dtype="f32", **extra):
    """``extra``: further config fields, the same on both sides."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jlm.TransformerLMConfig(**SMALL, tied_output=tied, fused_head=fused_head,
                                   dtype=jdt, **extra)
    tcfg = tlm.TransformerLMConfig(**SMALL, tied_output=tied, fused_head=fused_head,
                                   dtype=tdt, **extra)
    jparams = _jax_params(tied)
    return (jlm.TransformerLM(jcfg), jparams, tlm.TransformerLM(tcfg),
            from_jax_params(jparams))


def _batch(with_mask, seed=0):
    batch = jlm.synthetic_batch(jlm.TransformerLMConfig(**SMALL), 4, 16, seed=seed)
    if with_mask:
        mask = np.ones_like(batch["tokens"])
        mask[0, 10:] = 0
        mask[2, 3:] = 0
        batch["mask"] = mask
    return batch


@pytest.mark.parametrize("tied", [True, False])
def test_hidden_and_logits_match_flax(tied):
    jmodel, jparams, tmodel, tparams = _pair(tied, fused_head=False)
    tokens = _batch(False)["tokens"][:, :-1]
    for kwargs in ({"return_hidden": True}, {}, {"pos_offset": 5}):
        want = jmodel.apply({"params": jparams}, jnp.asarray(tokens), **kwargs)
        got = tlm.apply(tmodel, tparams, torch.tensor(tokens).long(), **kwargs)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("fused_head", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_loss_matches_flax(tied, fused_head, with_mask):
    jmodel, jparams, tmodel, tparams = _pair(tied, fused_head)
    batch = _batch(with_mask)
    want = jlm.make_loss_fn(jmodel)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tlm.make_loss_fn(tmodel)(tparams, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
@pytest.mark.parametrize("remat", [True, False])
def test_attention_impls_and_remat_match_flax(impl, remat):
    """The long-context paths: flash (its kernels' plain versions here, the
    Pallas kernels in interpret mode on the JAX side) and blockwise attention,
    each with and without rematerialized blocks. Loss to rtol 1e-5, every
    parameter gradient to rtol 1e-4 (atol 1e-6 for entries near zero: two
    f32 summation orders)."""
    jmodel, jparams, tmodel, tparams = _pair(False, fused_head=False,
                                             attention_impl=impl, remat=remat)
    batch = _batch(True, seed=1)
    # Jitted: the Pallas interpreter runs eagerly at about twice the time.
    want_loss, want_grads = jax.jit(jax.value_and_grad(jlm.make_loss_fn(jmodel)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss = tlm.make_loss_fn(tmodel)(leaves, {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = to_jax_params(dict(zip(leaves, grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    for path, value in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_recomputes_blocks_in_backward(monkeypatch):
    """remat replays each block in the backward pass, after apply's
    functional_call has put the meta parameters back: the replay must read
    the real ones. The flash forward runs once per layer in the forward
    pass and once more per layer in the replay."""
    _, _, tmodel, tparams = _pair(False, fused_head=False, attention_impl="flash",
                                  remat=True)
    calls = []
    real_fwd = tfa.flash_fwd

    def counting_fwd(q, *args, **kwargs):
        calls.append(q.device.type)
        return real_fwd(q, *args, **kwargs)

    monkeypatch.setattr(tfa, "flash_fwd", counting_fwd)
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    batch = {k: torch.tensor(v) for k, v in _batch(False).items()}
    loss = tlm.make_loss_fn(tmodel)(leaves, batch)
    assert len(calls) == SMALL["n_layers"]
    loss.backward()
    assert calls == ["cpu"] * (2 * SMALL["n_layers"])
    assert all(v.grad is not None and v.grad.abs().sum() > 0 for v in leaves.values())


def test_bf16_loss_tracks_flax():
    """The compute dtype the card runs: bf16 activations, f32 params. The two
    frameworks round bf16 at different places (torch computes elementwise ops
    in f32 and rounds once), so the loss agrees to 1e-2 relative."""
    jmodel, jparams, tmodel, tparams = _pair(False, fused_head=True, dtype="bf16")
    batch = _batch(False)
    want = jlm.make_loss_fn(jmodel)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tlm.make_loss_fn(tmodel)(tparams, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


def test_layernorm_is_flax_layernorm():
    """eps 1e-6 (torch's default is 1e-5) and f32 fast-variance statistics:
    at a variance of 1e-6 the eps alone moves the output by a third."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 1e-3).astype(np.float32)
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, x)
    ln = tlm.LayerNorm(64, torch.float32)
    got = torch.func.functional_call(ln, {"scale": torch.tensor(scale),
                                          "bias": torch.tensor(bias)}, (torch.tensor(x),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gelu_mask_and_attention_follow_flax():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.tensor(x), approximate="tanh").numpy(),
        np.asarray(fnn.gelu(x)), rtol=1e-6, atol=1e-6)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tlm.causal_mask(7, tdt).float().numpy(),
            np.asarray(jlm.causal_mask(7, jdt).astype(jnp.float32)))
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 6, 2, 8).astype(np.float32) for _ in range(3))
    want = jlm.dot_product_attention(q, k, v, jlm.causal_mask(6, jnp.float32), jnp.float32)
    got = tlm.dot_product_attention(*(torch.tensor(a) for a in (q, k, v)),
                                    tlm.causal_mask(6, torch.float32), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_params_round_trip_and_layouts():
    _, jparams, tmodel, tparams = _pair(False, fused_head=True)
    assert set(tparams) == {k for k, _ in tmodel.named_parameters()}
    for key, p in tmodel.named_parameters():
        assert tuple(tparams[key].shape) == tuple(p.shape), key
    assert tuple(tparams["block_0.attn.query.kernel"].shape) == (64, 2, 32)
    assert tuple(tparams["block_0.attn.out.kernel"].shape) == (2, 32, 64)
    back = to_jax_params(tparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_init_params_matches_flax_shapes_and_scales():
    cfg = tlm.TransformerLMConfig(**SMALL, tied_output=False, dtype=torch.float32)
    _, params = tlm.init_params(cfg, seed=0, device="cpu")
    _, again = tlm.init_params(cfg, seed=0, device="cpu")
    jflat = from_jax_params(_jax_params(False))
    assert set(params) == set(jflat)
    for key, value in params.items():
        assert value.shape == jflat[key].shape and value.device.type == "cpu", key
        torch.testing.assert_close(value, again[key])
        # Same initializer family: the spreads agree to sampling noise.
        np.testing.assert_allclose(float(value.std()), float(jflat[key].std()),
                                   rtol=0.2, atol=1e-6)


def test_unported_paths_raise():
    """Decode is ported: a KV-cache prefill gives the full forward's logits
    (its parity with flax's decode is tests/test_torch_generate.py's). Ring
    and Ulysses are ported, and without a group each is a group of one rank:
    the flash model's logits."""
    _, _, ring, tparams = _pair(False, fused_head=False, attention_impl="ring")
    _, _, ulysses, _ = _pair(False, fused_head=False, attention_impl="ulysses")
    _, _, flash, _ = _pair(False, fused_head=False, attention_impl="flash")
    tokens = torch.tensor(_batch(False)["tokens"][:, :-1]).long()
    want = tlm.apply(flash, tparams, tokens, pos_offset=3)
    torch.testing.assert_close(tlm.apply(ring, tparams, tokens, pos_offset=3), want)
    torch.testing.assert_close(tlm.apply(ulysses, tparams, tokens, pos_offset=3), want,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="attention_impl"):
        tlm.TransformerLMConfig(**SMALL, attention_impl="nope")
    _, _, dot, _ = _pair(False, fused_head=False)
    cache = tlm.init_cache(dot.config, tokens.shape[0], "cpu")
    torch.testing.assert_close(tlm.apply(dot, tparams, tokens, decode=True, cache=cache),
                               tlm.apply(dot, tparams, tokens), **ACT)
    assert int(cache["block_0.attn.cache_index"]) == tokens.shape[1]
