"""The port's decode paths and generation (autodist_tpu_torch.models:
``transformer_lm`` KV cache and ``generate``, ``lstm_lm`` carry cache and
``generate``, ``common.sample_logits``) against the JAX package, one set of
weights fed to both through ``from_jax_params``.

Small: vocab 256, d_model 64 (4 heads), d_ff 128, 2 layers, max_len 64; the
LSTM at embedding 16, hidden 32. In f32 the logits and hidden states agree
to 1e-5 (the two frameworks' f32 summation orders) and greedy tokens exactly.
The LSTM's bf16 decode carry, rounded to bf16 between steps as flax's is,
agrees to 2**-8 absolute: within a step the port's cell kernel keeps
``f * c + i * g`` and ``o * tanh(c)`` in f32 where flax rounds each product
to bf16 first. Sampled tokens have no parity with JAX (``jax.random``
cannot be reproduced in torch); the filter in front of the draw does, and
the sampler's own properties (seeded, row-independent) are held here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import common as jcommon
from autodist_tpu.models import lstm_lm as jlstm
from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu_torch import from_jax_params, to_jax_params
from autodist_tpu_torch.models import common as tcommon
from autodist_tpu_torch.models import lstm_lm as tlstm
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.ops import lstm_cell

SMALL = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_len=64)
LSTM_SMALL = dict(vocab_size=256, emb_dim=16, hidden_dim=32, n_layers=2)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_CARRY_ATOL = 2.0 ** -8


@functools.cache
def _untied_params():
    """The untied tree, drawn by the port's initializers (a flax init
    compiles for seconds) and carried to JAX by ``to_jax_params``; the tied
    model's is it without ``lm_head`` (its head is the embedding table)."""
    cfg = tlm.TransformerLMConfig(**SMALL, tied_output=False, dtype=torch.float32)
    return to_jax_params(tlm.init_params(cfg, seed=3, device="cpu")[1])


@functools.cache
def _lm(tied):
    """(JAX model, JAX params as numpy, port model, port params) in f32."""
    jparams = {k: v for k, v in _untied_params().items() if not (tied and k == "lm_head")}
    jmodel = jlm.TransformerLM(jlm.TransformerLMConfig(**SMALL, tied_output=tied,
                                                       dtype=jnp.float32))
    tmodel = tlm.TransformerLM(tlm.TransformerLMConfig(**SMALL, tied_output=tied,
                                                       dtype=torch.float32))
    return jmodel, jparams, tmodel, from_jax_params(jparams)


@functools.cache
def _lstm_params():
    """One init, as :func:`_untied_params` (the tree and its f32 params do
    not depend on the compute dtype)."""
    cfg = tlstm.LSTMLMConfig(**LSTM_SMALL, dtype=torch.float32)
    return to_jax_params(tlstm.init_params(cfg, seed=3, device="cpu")[1])


@functools.cache
def _lstm(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jparams = _lstm_params()
    jmodel = jlstm.LSTMLMWithHead(jlstm.LSTMLMConfig(**LSTM_SMALL, dtype=jdt))
    tmodel = tlstm.LSTMLMWithHead(tlstm.LSTMLMConfig(**LSTM_SMALL, dtype=tdt))
    return jmodel, jparams, tmodel, from_jax_params(jparams)


@functools.cache
def _jax_decode(kind, key):
    """JAX's decode apply, jitted (eager flax applies cost seconds each):
    ``prefill(params, tokens)`` and ``step(params, cache, tokens, pos)``,
    each returning ``(output, cache)``."""
    jmodel = (_lm if kind == "lm" else _lstm)(key)[0]
    kwargs = {} if kind == "lm" else None

    def prefill(params, tokens):
        out, var = jmodel.apply({"params": params}, tokens, decode=True, mutable=["cache"])
        return out, var["cache"]

    def step(params, cache, tokens, pos):
        extra = {"pos_offset": pos} if kwargs is not None else {}
        out, var = jmodel.apply({"params": params, "cache": cache}, tokens, decode=True,
                                mutable=["cache"], **extra)
        return out, var["cache"]
    return jax.jit(prefill), jax.jit(step)


def _tokens(batch, length, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (batch, length)).astype(np.int32)


def _jax_cache_flat(cache):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache)}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("tied", [True, False])
def test_decode_logits_and_cache_match_jax(tied):
    """Prefill (the chunked cache write) then scalar-position steps, then
    one per-row step: every logit against JAX's decode and the prefix's
    against the full forward; the cache's contents against JAX's ``cache``
    collection, key by key."""
    _, jparams, tmodel, tparams = _lm(tied)
    prefill, step = _jax_decode("lm", tied)
    toks = _tokens(3, 10)
    cache = tlm.init_cache(tmodel.config, 3, "cpu")
    assert all(v.device.type == "cpu" for v in cache.values())
    want, jcache = prefill(jparams, jnp.asarray(toks[:, :6]))
    got = tlm.apply(tmodel, tparams, torch.tensor(toks[:, :6]).long(), decode=True, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    full = tlm.apply(tmodel, tparams, torch.tensor(toks).long())
    np.testing.assert_allclose(got.numpy(), full[:, :6].numpy(), **F32)
    for i in range(6, 10):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        got = tlm.apply(tmodel, tparams, torch.tensor(toks[:, i:i + 1]).long(), pos_offset=i,
                        decode=True, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(), **F32)
    # Per-row positions: row 1 rewrites position 2, row 2 parks at 0.
    pos = np.array([10, 2, 0], np.int32)
    want, jcache = step(jparams, jcache, jnp.asarray(toks[:, :1]), jnp.asarray(pos))
    got = tlm.apply(tmodel, tparams, torch.tensor(toks[:, :1]).long(),
                    pos_offset=torch.tensor(pos), decode=True, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jcache = _jax_cache_flat(jcache)
    assert sorted(jcache) == sorted(cache)
    for key, value in cache.items():
        np.testing.assert_allclose(value.numpy(), jcache[key], **F32)
    assert int(cache["block_0.attn.cache_index"]) == 10


def test_per_row_positions_need_decode_and_writes_stay_in_the_cache():
    """A per-row ``pos_offset`` without decode raises in both packages. A
    chunk whose start would run past the cache is clamped into it, as
    ``dynamic_update_slice`` clamps (JAX's position gather fills NaN
    there; the port clamps its index too). No engine makes such a call:
    the batcher caps prompt + new tokens at max_len, idle rows park at 0."""
    jmodel, jparams, tmodel, tparams = _lm(False)
    with pytest.raises(ValueError, match="per-row pos_offset requires decode"):
        jmodel.apply({"params": jparams}, jnp.zeros((2, 1), jnp.int32),
                     pos_offset=jnp.asarray([0, 1]))
    with pytest.raises(ValueError, match="per-row pos_offset requires decode"):
        tlm.apply(tmodel, tparams, torch.zeros((2, 1), dtype=torch.long),
                  pos_offset=torch.tensor([0, 1]))
    width = SMALL["max_len"]
    cache = tlm.init_cache(tmodel.config, 2, "cpu")
    tlm.apply(tmodel, tparams, torch.tensor(_tokens(2, 4, seed=4)).long(),
              pos_offset=torch.tensor([width - 2, 5]), decode=True, cache=cache)
    written = cache["block_0.attn.cached_key"].abs().sum(dim=(2, 3)) > 0
    assert written[0].nonzero().flatten().tolist() == list(range(width - 4, width))
    assert written[1].nonzero().flatten().tolist() == [5, 6, 7, 8]
    # The scalar path writes at cache_index: a 3-token chunk at width - 1
    # lands at [width - 3, width).
    for i in range(SMALL["n_layers"]):
        cache[f"block_{i}.attn.cache_index"].fill_(width - 1)
    before = cache["block_0.attn.cached_key"].clone()
    tlm.apply(tmodel, tparams, torch.ones((2, 3), dtype=torch.long), pos_offset=width - 1,
              decode=True, cache=cache)
    changed = (cache["block_0.attn.cached_key"] != before).any(dim=(0, 2, 3))
    assert changed.nonzero().flatten().tolist() == list(range(width - 3, width))
    assert int(cache["block_0.attn.cache_index"]) == width + 2


@functools.cache
def _jax_generate(tied, n_new):
    jmodel = _lm(tied)[0]
    return jlm.make_generate_fn(jmodel, n_new)


@pytest.mark.parametrize("tied", [True, False])
def test_greedy_generate_tokens_equal_jax(tied):
    jmodel, jparams, tmodel, tparams = _lm(tied)
    prompt = _tokens(2, 5, seed=3)
    want = np.asarray(_jax_generate(tied, 7)(jparams, jnp.asarray(prompt)))
    got = tlm.generate(tmodel, tparams, torch.tensor(prompt), 7)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tlm.make_generate_fn(tmodel, 1)(tparams, torch.tensor(prompt))
    np.testing.assert_array_equal(one.numpy(), want[:, :1])


def _jax_filtered(logits, temperature, top_k, top_p, monkeypatch):
    """The logits JAX's ``sample_logits`` hands ``jax.random.categorical``."""
    seen = {}

    def capture(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jcommon.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k, top_p)
    return seen["logits"]


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.5), (0, 0.9), (8, 0.9), (1, 0.0),
                                         (0, 1e-6)])
def test_filter_keeps_the_tokens_jax_keeps(top_k, top_p, monkeypatch):
    """top-k then top-p (the crossing token kept): the same survivors as the
    JAX sampler's filter on the same logits, and the same scaled values."""
    logits = (np.random.RandomState(top_k).randn(4, 97) * 2).astype(np.float32)
    want = _jax_filtered(logits, 0.8, top_k, top_p, monkeypatch)
    got = tcommon.filter_logits(torch.tensor(logits), 0.8, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)


def test_sampler_is_seeded_row_independent_and_greedy_at_zero():
    logits = torch.tensor(np.random.RandomState(0).randn(6, 50).astype(np.float32))
    seeds = torch.arange(6, dtype=torch.int64) * 7919
    a = tcommon.sample_logits(logits, seeds, 1.0)
    np.testing.assert_array_equal(a.numpy(), tcommon.sample_logits(logits, seeds, 1.0).numpy())
    assert not torch.equal(a, tcommon.sample_logits(logits, seeds + 1, 1.0))
    # A row's draw depends on its own logits and seed only.
    for b in range(6):
        alone = tcommon.sample_logits(logits[b:b + 1], seeds[b:b + 1], 1.0)
        assert int(alone[0]) == int(a[b])
    np.testing.assert_array_equal(tcommon.sample_logits(logits, seeds, 1.0, top_k=1).numpy(),
                                  tcommon.sample_logits(logits).numpy())
    with pytest.raises(ValueError, match="needs a key"):
        tcommon.sample_logits(logits, None, 0.7)
    # The nucleus at p = 0.5 of probabilities (.6, .3, .1) is token 0 alone.
    probs = torch.log(torch.tensor([[0.6, 0.3, 0.1]]))
    draws = {int(tcommon.sample_logits(probs, torch.tensor([s]), 1.0, top_p=0.5)[0])
             for s in range(64)}
    assert draws == {0}
    # generate's row 0 samples with the step seed itself: batch 1 is a row.
    _, _, tmodel, tparams = _lm(True)
    prompt = torch.tensor(_tokens(2, 4, seed=9))
    both = tlm.generate(tmodel, tparams, prompt, 5, temperature=0.9, top_k=8, rng=11)
    first = tlm.generate(tmodel, tparams, prompt[:1], 5, temperature=0.9, top_k=8, rng=11)
    np.testing.assert_array_equal(both[:1].numpy(), first.numpy())


def test_generate_validates():
    _, _, tmodel, tparams = _lm(True)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tlm.generate(tmodel, tparams, torch.zeros((1, 60), dtype=torch.long), 5)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tlm.generate(tmodel, tparams, torch.zeros((1, 3), dtype=torch.long), 0)
    with pytest.raises(ValueError, match="needs cache"):
        tlm.apply(tmodel, tparams, torch.zeros((1, 3), dtype=torch.long), decode=True)
    remat = tlm.TransformerLM(tlm.TransformerLMConfig(**SMALL, remat=True, dtype=torch.float32))
    want = tlm.generate(tmodel, tparams, torch.ones((2, 3), dtype=torch.long), 2)
    np.testing.assert_array_equal(
        tlm.generate(remat, tparams, torch.ones((2, 3), dtype=torch.long), 2).numpy(),
        want.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_decode_carry_matches_jax(dtype):
    """Prefill then single-token steps: hidden states and the carries
    against flax's decode (its carry in the compute dtype); at f32 the
    decode also equals the full recurrence."""
    _, jparams, tmodel, tparams = _lstm(dtype)
    prefill, step = _jax_decode("lstm", dtype)
    tol = F32 if dtype == "f32" else dict(rtol=0, atol=BF16_CARRY_ATOL)
    toks = _tokens(3, 9)
    cache = tlstm.init_cache(tmodel.config, 3, "cpu")
    want, jcache = prefill(jparams, jnp.asarray(toks[:, :5]))
    got = [tlstm.apply(tmodel, tparams, torch.tensor(toks[:, :5]).long(), decode=True,
                       cache=cache)]
    np.testing.assert_allclose(_np(got[0]), np.asarray(want, np.float32), **tol)
    for i in range(5, 9):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        got.append(tlstm.apply(tmodel, tparams, torch.tensor(toks[:, i:i + 1]).long(),
                               decode=True, cache=cache))
        np.testing.assert_allclose(_np(got[-1]), np.asarray(want, np.float32), **tol)
    jcache = _jax_cache_flat(jcache)
    for i in range(LSTM_SMALL["n_layers"]):
        for j, part in enumerate(cache[f"lm.carry_{i}"]):
            assert part.dtype == tmodel.config.dtype
            np.testing.assert_allclose(_np(part), jcache[f"lm.carry_{i}.{j}"].astype(np.float32),
                                       **tol)
    if dtype == "f32":
        full = tlstm.apply(tmodel, tparams, torch.tensor(toks).long())
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(), **F32)


def test_lstm_greedy_generate_equals_jax():
    """At bf16 (tests/test_torch_lstm_lm.py holds f32)."""
    jmodel, jparams, tmodel, tparams = _lstm("bf16")
    prompt = _tokens(2, 4, seed=1)
    want = np.asarray(jlstm.make_generate_fn(jmodel, 5)(jparams, jnp.asarray(prompt)))
    got = tlstm.generate(tmodel, tparams, torch.tensor(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_from_a_carry_matches_the_plain_cells(dtype):
    """The recurrence's initial and final carry: steps from ``(c0, h0)``
    equal the plain cell looped by hand, and the final carry is the last
    step's."""
    gen = torch.Generator().manual_seed(2)
    b, t, hid = 3, 4, 8
    x = (torch.randn(b, t, 4 * hid, generator=gen) * 0.5).to(dtype)
    wh = (torch.randn(hid, 4 * hid, generator=gen) * 0.3).to(dtype)
    bh = (torch.randn(4 * hid, generator=gen) * 0.1).to(dtype)
    c0 = torch.randn(b, hid, generator=gen)
    h0 = torch.randn(b, hid, generator=gen)
    with torch.no_grad():
        (c_t, h_t), hs = lstm_cell.lstm_recurrence(x, wh, bh, initial_carry=(c0, h0),
                                                   return_carry=True)
    c, h_in, want = c0, h0.to(dtype), []
    for s in range(t):
        c, h, h_in, _ = lstm_cell.cell_fwd_plain(h_in @ wh, bh, x[:, s], c)
        want.append(h)
    torch.testing.assert_close(hs, torch.stack(want, 1), rtol=0, atol=0)
    torch.testing.assert_close(c_t, c, rtol=0, atol=0)
    torch.testing.assert_close(h_t, want[-1], rtol=0, atol=0)
