"""The port's text models (autodist_tpu_torch.models.bert and ncf) against the
JAX package's flax models, with one set of weights: flax initializes, and
``from_jax_params`` carries the tree across.

Tiny BERT (d32, 4 heads, 2 layers, vocab 128, seq 16, 4 prediction slots)
and tiny NeuMF, both in f32, so the only differences are the two
frameworks' f32 summation orders: the loss to rtol 1e-5, every gradient to
rtol 1e-4 / atol 1e-6 (as tests/test_torch_transformer_lm.py holds the
flagship). The BERT batch holds real pad tokens (id 0), so the additive pad
mask changes the result. The sparse flags of the model spec walked on an
example batch, and ``Parallax``'s choice of PS or all-reduce for each
variable, must equal the JAX package's exactly (they are discrete): BERT
at bf16 and f32, NCF at f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import ncf as jncf
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import Parallax as JParallax
from autodist_tpu_torch import AutoDist, Parallax, from_jax_params, to_jax_params
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.resource_spec import ResourceSpec

BERT = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=16)
NCF = dict(num_users=64, num_items=32, mf_dim=8, mlp_dims=(16, 8, 4))
SEQ, PREDICTIONS, ROWS = 16, 4, 4
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
FOUR = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bert_batch(seed=0):
    """The synthetic batch with pad tokens: row 0 padded from 10, row 2
    from 5 (its weights cover only slots at unpadded positions, as the MLM
    batcher's do), and a second segment in row 1."""
    batch = jbert.synthetic_batch(jbert.BertConfig(**BERT), ROWS, SEQ,
                                  n_predictions=PREDICTIONS, seed=seed)
    batch["tokens"][0, 10:] = 0
    batch["tokens"][2, 5:] = 0
    batch["token_types"][1, 8:] = 1
    batch["mlm_positions"][2] = [1, 3, 4, 0]
    batch["mlm_weights"][2, 3] = 0.0
    return batch


@functools.cache
def _jax_bert_params():
    model = jbert.Bert(jbert.BertConfig(**BERT, dtype=jnp.float32))
    batch = _bert_batch()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(batch["tokens"]),
                                 jnp.asarray(batch["token_types"]))["params"]
    return jax.device_get(params)


@functools.cache
def _jax_ncf_params():
    model = jncf.NeuMF(jncf.NeuMFConfig(**NCF))
    batch = jncf.synthetic_batch(jncf.NeuMFConfig(**NCF), 8)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(batch["users"]),
                                 jnp.asarray(batch["items"]))["params"]
    return jax.device_get(params)


def _grads(jloss_fn, tloss_fn, jparams, batch):
    """``(jax loss, jax grads, torch loss, torch grads)`` at ``jparams``,
    the gradients as flat state dicts."""
    loss, grads = jax.jit(jax.value_and_grad(jloss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_() for k, v in from_jax_params(jparams).items()}
    tloss = tloss_fn(leaves, {k: torch.tensor(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))
    return (float(loss), from_jax_params(jax.device_get(grads)), float(tloss.detach()),
            dict(zip(leaves, tgrads)))


def _assert_grads_match(jloss_fn, tloss_fn, jparams, batch):
    want_loss, want, got_loss, got = _grads(jloss_fn, tloss_fn, jparams, batch)
    assert set(got) == set(want)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS)
    for key, g in want.items():
        np.testing.assert_allclose(got[key].numpy(), g.numpy(), err_msg=key, **GRAD)


def test_bert_param_tree_matches_flax():
    """The port's init names and shapes every parameter as flax does."""
    model, params = tbert.init_params(tbert.BertConfig(**BERT), seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in from_jax_params(_jax_bert_params()).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert float(params["layer_0.query.bias"].abs().sum()) == 0.0
    assert torch.equal(params["ln_f.scale"], torch.ones(BERT["d_model"]))


@pytest.mark.parametrize("positions", [True, False])
def test_bert_logits_match_flax(positions):
    """Logits at the prediction slots (gathered before the head) and over
    every position, with the pad mask live."""
    jparams = _jax_bert_params()
    batch = _bert_batch()
    jmodel = jbert.Bert(jbert.BertConfig(**BERT, dtype=jnp.float32))
    tmodel = tbert.Bert(tbert.BertConfig(**BERT, dtype=torch.float32))
    pos = batch["mlm_positions"] if positions else None
    want = jmodel.apply({"params": jparams}, jnp.asarray(batch["tokens"]),
                        jnp.asarray(batch["token_types"]),
                        mlm_positions=None if pos is None else jnp.asarray(pos))
    got = tbert.apply(tmodel, from_jax_params(jparams), torch.tensor(batch["tokens"]),
                      torch.tensor(batch["token_types"]),
                      None if pos is None else torch.tensor(pos))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bert_pad_mask_changes_the_loss():
    """Padding a row changes what the other positions attend to: the loss
    of the padded batch differs from that of the same ids with the pads
    replaced, in both packages alike."""
    jparams = _jax_bert_params()
    tmodel = tbert.Bert(tbert.BertConfig(**BERT, dtype=torch.float32))
    padded = _bert_batch()
    unpadded = {k: v.copy() for k, v in padded.items()}
    unpadded["tokens"][unpadded["tokens"] == 0] = 7
    loss = tbert.make_mlm_loss_fn(tmodel)
    values = [float(loss(from_jax_params(jparams), {k: torch.tensor(v) for k, v in b.items()}))
              for b in (padded, unpadded)]
    assert abs(values[0] - values[1]) > 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_bert_loss_and_grads_match_flax(seed):
    jmodel = jbert.Bert(jbert.BertConfig(**BERT, dtype=jnp.float32))
    tmodel = tbert.Bert(tbert.BertConfig(**BERT, dtype=torch.float32))
    _assert_grads_match(jbert.make_mlm_loss_fn(jmodel), tbert.make_mlm_loss_fn(tmodel),
                        _jax_bert_params(), _bert_batch(seed))


def test_bert_bf16_loss_tracks_f32():
    """The bf16 compute path (the card's) on the same weights: within the
    rtol 1e-2 the chip smoke holds it to."""
    params = from_jax_params(_jax_bert_params())
    batch = {k: torch.tensor(v) for k, v in _bert_batch().items()}
    losses = [float(tbert.make_mlm_loss_fn(tbert.Bert(tbert.BertConfig(**BERT, dtype=dt)))(
        params, batch)) for dt in (torch.bfloat16, torch.float32)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-2)


def test_ncf_param_tree_and_logits_match_flax():
    jparams = _jax_ncf_params()
    model, params = tncf.init_params(tncf.NeuMFConfig(**NCF), seed=0, device="cpu")
    want = {k: tuple(v.shape) for k, v in from_jax_params(jparams).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    batch = jncf.synthetic_batch(jncf.NeuMFConfig(**NCF), 16, seed=3)
    expect = jncf.NeuMF(jncf.NeuMFConfig(**NCF)).apply(
        {"params": jparams}, jnp.asarray(batch["users"]), jnp.asarray(batch["items"]))
    got = tncf.apply(model, from_jax_params(jparams), torch.tensor(batch["users"]),
                     torch.tensor(batch["items"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_ncf_loss_and_grads_match_flax(seed):
    cfg = jncf.NeuMFConfig(**NCF)
    _assert_grads_match(jncf.make_loss_fn(jncf.NeuMF(cfg)),
                        tncf.make_loss_fn(tncf.NeuMF(tncf.NeuMFConfig(**NCF))),
                        _jax_ncf_params(), jncf.synthetic_batch(cfg, 32, seed=seed))


def _flags(spec):
    return {n: (p.sparse, p.index_leaf) for n, p in spec.params.items()}


def _routes(jspec, tspec):
    """Parallax's node configs for each package's spec on 4 devices."""
    jbuilt = JParallax().build(jspec, JResourceSpec(resource_info=FOUR))
    tbuilt = Parallax().build(tspec, ResourceSpec(resource_info=FOUR))
    return (MessageToDict(jbuilt.proto, preserving_proto_field_name=True)["node_config"],
            tbuilt.to_dict()["node_config"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bert_sparse_flags_and_parallax_match_jax(dtype):
    """bf16: nothing sparse (each table is cast before its gather, the word
    table is also the head, and the positional table is unsqueezed before
    its slice); f32: the type table, indexed by ``token_types``."""
    jdt, tdt = DTYPES[dtype]
    batch = _bert_batch()
    jspec = JAutoDist(strategy_builder=JParallax())._model_spec_for(
        jbert.make_mlm_loss_fn(jbert.Bert(jbert.BertConfig(**BERT, dtype=jdt))),
        _jax_bert_params(), batch, None)
    tspec = AutoDist._model_spec_for(
        tbert.make_mlm_loss_fn(tbert.Bert(tbert.BertConfig(**BERT, dtype=tdt))),
        from_jax_params(_jax_bert_params()), batch, None)
    assert _flags(tspec) == _flags(jspec)
    want = {"bfloat16": [], "float32": [("type_embed/embedding", "token_types")]}[dtype]
    assert [(n, p.index_leaf) for n, p in tspec.params.items() if p.sparse] == want
    jroutes, troutes = _routes(jspec, tspec)
    assert troutes == jroutes


def test_ncf_sparse_flags_and_parallax_match_jax():
    """Every table is sparse, indexed by ``users`` or ``items``, and
    ``Parallax`` sends each to a PS synchronizer, the dense layers to the
    all-reduce (tests/test_models.py:182-184 for the JAX side)."""
    cfg = jncf.NeuMFConfig(**NCF)
    batch = jncf.synthetic_batch(cfg, 16)
    jspec = JAutoDist(strategy_builder=JParallax())._model_spec_for(
        jncf.make_loss_fn(jncf.NeuMF(cfg)), _jax_ncf_params(), batch, None)
    tspec = AutoDist._model_spec_for(tncf.make_loss_fn(tncf.NeuMF(tncf.NeuMFConfig(**NCF))),
                                     from_jax_params(_jax_ncf_params()), batch, None)
    assert _flags(tspec) == _flags(jspec)
    assert {n: p.index_leaf for n, p in tspec.params.items() if p.sparse} == {
        "mf_item_embed/embedding": "items", "mf_user_embed/embedding": "users",
        "mlp_item_embed/embedding": "items", "mlp_user_embed/embedding": "users"}
    jroutes, troutes = _routes(jspec, tspec)
    assert troutes == jroutes
    kinds = {n["var_name"]: ("ps" if "ps_synchronizer" in n else "ar") for n in troutes}
    assert {n for n, k in kinds.items() if k == "ps"} == {
        n for n in kinds if n.endswith("_embed/embedding")}


def test_synthetic_batches_equal_jax():
    for key, value in jbert.synthetic_batch(jbert.BertConfig(**BERT), 3, SEQ, 5).items():
        np.testing.assert_array_equal(
            tbert.synthetic_batch(tbert.BertConfig(**BERT), 3, SEQ, 5)[key], value)
    for key, value in jncf.synthetic_batch(jncf.NeuMFConfig(**NCF), 7, seed=2).items():
        np.testing.assert_array_equal(
            tncf.synthetic_batch(tncf.NeuMFConfig(**NCF), 7, seed=2)[key], value)


def test_port_init_round_trips_through_flax():
    """The port's own init feeds flax as it is (``to_jax_params``): flax's
    loss on it equals the port's."""
    model, params = tncf.init_params(tncf.NeuMFConfig(**NCF), seed=4, device="cpu")
    cfg = jncf.NeuMFConfig(**NCF)
    batch = jncf.synthetic_batch(cfg, 16)
    want = jncf.make_loss_fn(jncf.NeuMF(cfg))(to_jax_params(params),
                                              {k: jnp.asarray(v) for k, v in batch.items()})
    got = tncf.make_loss_fn(model)(params, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), **LOSS)
