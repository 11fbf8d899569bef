"""The port's LSTM LM (autodist_tpu_torch.models.lstm_lm) against the flax
model, with one set of weights fed to both through ``from_jax_params``.

Small: vocab 256, embedding 16, hidden 32, 2 layers, 12 steps, 16
negatives. Everything runs in f32 on both sides, so the differences are the
two frameworks' f32 summation orders: h and losses to rtol 1e-5 (atol
1e-6), gradients to rtol 1e-4 of each parameter's largest entry. The full
softmax through the fused head is held against the JAX package's Pallas
kernels in interpret mode (rtol 1e-5 / 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.model_spec import ModelSpec as JaxModelSpec
from autodist_tpu.models import lstm_lm as jlstm
from autodist_tpu_torch import from_jax_params, to_jax_params
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import lstm_lm as tlstm
from autodist_tpu_torch.ops import lstm_cell

SMALL = dict(vocab_size=256, emb_dim=16, hidden_dim=32, n_layers=2, num_sampled=16)
BATCH, SEQ = 4, 12
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-4


def _configs(**kw):
    return (jlstm.LSTMLMConfig(**SMALL, dtype=jnp.float32, **kw),
            tlstm.LSTMLMConfig(**SMALL, dtype=torch.float32, **kw))


@functools.cache
def _jax_model(subtract_log_q=True):
    jcfg, _ = _configs(subtract_log_q=subtract_log_q)
    model, params = jlstm.init_params(jcfg, rng=jax.random.PRNGKey(3))
    return model, jax.device_get(params)


def _torch_model(subtract_log_q=True):
    _, tcfg = _configs(subtract_log_q=subtract_log_q)
    return tlstm.LSTMLMWithHead(tcfg)


def _batch(sampled=True, seed=0):
    jcfg, _ = _configs()
    return jlstm.synthetic_batch(jcfg, BATCH, SEQ, seed=seed, sampled=sampled)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads(jgrads, tgrads):
    want = from_jax_params(jax.device_get(jgrads))
    assert sorted(want) == sorted(tgrads)
    for k, w in want.items():
        scale = float(w.abs().max()) or 1.0
        err = float((tgrads[k] - w).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)


def test_params_names_shapes_and_weights_carry_across():
    """The port's state dict has the JAX tree's paths (flax's
    ``OptimizedLSTMCell_{i}`` and gate names, not ``lstm_{i}``) and shapes;
    ``from_jax_params`` and ``to_jax_params`` carry the weights both ways."""
    _, jparams = _jax_model()
    _, tcfg = _configs()
    model, init = tlstm.init_params(tcfg, device="cpu")
    flat = {k.replace("/", "."): v.shape for k, v in _flat(jparams).items()}
    assert {k: tuple(v.shape) for k, v in init.items()} == flat
    assert dict(model.named_parameters()).keys() == flat.keys()
    assert "lm.OptimizedLSTMCell_1.if.kernel" in flat and "lm.lstm_0" not in str(flat)
    params = from_jax_params(jparams)
    back = _flat(to_jax_params(params))
    for k, v in _flat(jparams).items():
        np.testing.assert_array_equal(back[k], v)
    # Flax's initializers by distribution: orthogonal hidden kernels, zero biases.
    wh = init["lm.OptimizedLSTMCell_0.hf.kernel"]
    np.testing.assert_allclose((wh.T @ wh).numpy(), np.eye(32), atol=1e-5)
    assert float(init["lm.OptimizedLSTMCell_0.hf.bias"].abs().max()) == 0.0
    assert abs(float(init["softmax_w"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("seed,sampled", [(0, True), (5, True), (0, False)])
def test_synthetic_batch_is_jax_bit_for_bit(seed, sampled):
    jcfg, tcfg = _configs()
    want = jlstm.synthetic_batch(jcfg, BATCH, SEQ, seed=seed, sampled=sampled)
    got = tlstm.synthetic_batch(tcfg, BATCH, SEQ, seed=seed, sampled=sampled)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_hidden_states_match_jax():
    jmodel, jparams = _jax_model()
    tokens = _batch()["tokens"][:, :-1]
    want = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, tokens))
    got = tlstm.apply(_torch_model(), from_jax_params(jparams), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, SEQ, 32)
    np.testing.assert_allclose(got.numpy(), want, **VAL)


@pytest.mark.parametrize("subtract_log_q,sampled", [(True, True), (False, True),
                                                   (True, False)])
def test_loss_and_grads_match_jax(subtract_log_q, sampled):
    """The sampled softmax (true and shared-negative gathers, log q, the
    accidental-hit mask), and without ``neg_ids`` the full softmax."""
    jmodel, jparams = _jax_model(subtract_log_q)
    batch = _batch(sampled)
    if sampled:
        # An accidental hit: the first target is also a sampled negative.
        batch["neg_ids"][3] = batch["tokens"][0, 1]
    loss, grads = jax.jit(jax.value_and_grad(jlstm.make_loss_fn(jmodel)))(jparams, batch)
    params = {k: v.requires_grad_(True) for k, v in from_jax_params(jparams).items()}
    got = tlstm.make_loss_fn(_torch_model(subtract_log_q))(params, _torch_batch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **VAL)
    _assert_grads(grads, {k: v.grad for k, v in params.items()})


def test_fused_full_softmax_loss_matches_jax_interpret():
    """The fused head's loss ("vd", with the bias, f32 h) on the plain
    versions against JAX's, whose Pallas kernels run in interpret mode."""
    jmodel, jparams = _jax_model()
    batch = _batch(sampled=False)
    loss, grads = jax.jit(jax.value_and_grad(jlstm.make_fused_full_softmax_loss_fn(jmodel)))(
        jparams, batch)
    params = {k: v.requires_grad_(True) for k, v in from_jax_params(jparams).items()}
    got = tlstm.make_fused_full_softmax_loss_fn(_torch_model())(params, _torch_batch(batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **VAL)
    _assert_grads(grads, {k: v.grad for k, v in params.items()})
    # The same objective as the logits path, in both packages.
    plain = jax.jit(jlstm.make_loss_fn(jmodel))(jparams, batch)
    np.testing.assert_allclose(got.item(), float(plain), rtol=1e-5)


def test_bf16_config_hands_the_head_f32_states():
    """flax's carry starts at the parameter dtype, so a bf16 compute dtype
    still gives f32 h, in both packages."""
    jcfg = jlstm.LSTMLMConfig(**SMALL, dtype=jnp.bfloat16)
    jmodel, jparams = jlstm.init_params(jcfg, rng=jax.random.PRNGKey(3))
    tokens = _batch()["tokens"][:, :-1]
    want = jax.jit(jmodel.apply)({"params": jparams}, tokens)
    tmodel = tlstm.LSTMLMWithHead(tlstm.LSTMLMConfig(**SMALL, dtype=torch.bfloat16))
    got = tlstm.apply(tmodel, from_jax_params(jax.device_get(jparams)),
                      torch.from_numpy(tokens))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # bf16 products and gates: the two frameworks round them alike but not
    # identically (XLA fuses the bf16 adds).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_sparse_walk_sees_the_jax_leaves(fused):
    """The walk of each loss marks the same parameters sparse as the JAX
    package's (the tables gathered by tokens, targets and negatives)."""
    jmodel, jparams = _jax_model()
    batch = _batch(sampled=not fused)
    jloss = (jlstm.make_fused_full_softmax_loss_fn if fused else jlstm.make_loss_fn)(jmodel)
    tloss = (tlstm.make_fused_full_softmax_loss_fn if fused
             else tlstm.make_loss_fn)(_torch_model())
    want = JaxModelSpec.from_loss_fn(jloss, jparams, batch)
    got = ModelSpec.from_loss_fn(tloss, from_jax_params(jparams), _torch_batch(batch))
    flags = lambda spec: {n: (p.sparse, p.index_leaf) for n, p in spec.params.items()}  # noqa: E731
    assert flags(got) == flags(want)
    assert flags(want)["lm/embed/embedding"][0]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_recurrence_backward_matches_autograd(dtype, rtol):
    """The recurrence's written-out backward (the cell kernels' plain
    versions, the weight gradients as one product over all steps) against
    autograd through the same forward written with differentiable ops.
    f32: summation orders only (rtol 1e-5 of each gradient's largest
    entry); bf16: the backward's own bf16 roundings (2e-2)."""
    gen = torch.Generator().manual_seed(0)
    b, t, hid = 3, 7, 8
    x = (torch.randn(b, t, 4 * hid, generator=gen) * 0.5).to(dtype)
    wh = (torch.randn(hid, 4 * hid, generator=gen) * 0.3).to(dtype)
    bh = (torch.randn(4 * hid, generator=gen) * 0.1).to(dtype)
    coef = torch.randn(b, t, hid, generator=gen)
    leaves = [v.clone().requires_grad_(True) for v in (x, wh, bh)]
    (lstm_cell.lstm_recurrence(*leaves) * coef).sum().backward()
    ref = [v.clone().requires_grad_(True) for v in (x, wh, bh)]
    c, h_t, hs = None, None, []
    for s in range(t):
        yh = None if s == 0 else h_t @ ref[1]
        c, h, h_t, _ = lstm_cell.cell_fwd_plain(yh, ref[2], ref[0][:, s], c)
        hs.append(h)
    (torch.stack(hs, 1) * coef).sum().backward()
    for got, want in zip(leaves, ref):
        scale = float(want.grad.float().abs().max())
        err = float((got.grad.float() - want.grad.float()).abs().max())
        assert got.grad.dtype == want.grad.dtype and err <= rtol * scale, (err, scale)


def test_decode_and_generate_raise_naming_serving():
    """Decode and generate are ported (serving): the carry cache's prefill
    and steps give flax's decode hidden states and carries at f32, and
    greedy generate its tokens."""
    jmodel, jparams = _jax_model()
    model, tparams = _torch_model(), from_jax_params(jparams)
    tokens = _batch(False)["tokens"][:, :6]
    want, var = jmodel.apply({"params": jparams}, jnp.asarray(tokens[:, :4]), decode=True,
                             mutable=["cache"])
    cache = tlstm.init_cache(model.config, BATCH, "cpu")
    got = tlstm.apply(model, tparams, torch.tensor(tokens[:, :4]).long(), decode=True,
                      cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    want, var = jmodel.apply({"params": jparams, "cache": var["cache"]},
                             jnp.asarray(tokens[:, 4:5]), decode=True, mutable=["cache"])
    got = tlstm.apply(model, tparams, torch.tensor(tokens[:, 4:5]).long(), decode=True,
                      cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    jcache = var["cache"]["lm"]
    for i in range(SMALL["n_layers"]):
        for part, jpart in zip(cache[f"lm.carry_{i}"], jcache[f"carry_{i}"]):
            np.testing.assert_allclose(part.numpy(), np.asarray(jpart), **VAL)
    want = np.asarray(jlstm.make_generate_fn(jmodel, 3)(jparams, jnp.asarray(tokens[:2, :4])))
    got = tlstm.generate(model, tparams, torch.tensor(tokens[:2, :4]), 3)
    np.testing.assert_array_equal(got.numpy(), want)
