"""The port's sparse-parameter walk against the JAX package's jaxpr walk.

For the flagship loss (``make_loss_fn(TransformerLM)``, 1 layer, untied
head, the logits head and the fused one), at bf16 and f32 compute, with and
without ``example_batch``, the port's ``AutoDist._model_spec_for`` must give
the JAX package's sparse flags and index leaves, and ``Parallax`` the same
node configs (which parameter goes to PS, and with what sparse flag). The
sentiment classifier's loss gathers ``batch["tokens"]`` as it is, so its
table is sparse with the index leaf ``tokens`` on both sides. Exact
equality: the flags are discrete.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf.json_format import MessageToDict

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import Parallax as JParallax
from autodist_tpu_torch import AutoDist, Parallax, from_jax_params
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.ops import fused_xent as fx
from autodist_tpu_torch.resource_spec import ResourceSpec

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32)
FOUR = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]}


@functools.cache
def _jax_params():
    cfg = jlm.TransformerLMConfig(**SMALL, tied_output=False, dtype=jnp.float32)
    return jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(0))[1])


def _flags(spec):
    return {n: (p.sparse, p.index_leaf) for n, p in spec.params.items()}


def _parallax(spec, package):
    """Node configs of Parallax built for ``spec`` on 4 devices, without ids."""
    if package == "jax":
        built = JParallax().build(spec, JResourceSpec(resource_info=FOUR))
        out = MessageToDict(built.proto, preserving_proto_field_name=True)
    else:
        out = Parallax().build(spec, ResourceSpec(resource_info=FOUR)).to_dict()
    return out["node_config"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_batch", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flagship_spec_and_parallax_match_jax(dtype, with_batch, fused):
    """Queue 3's table: bf16 with a batch marks only ``pos_embed`` (the
    table is cast before its gather); f32 marks both; no batch marks none."""
    jcfg = jlm.TransformerLMConfig(**SMALL, tied_output=False, fused_head=fused,
                                   dtype=getattr(jnp, dtype))
    tcfg = tlm.TransformerLMConfig(**SMALL, tied_output=False, fused_head=fused,
                                   dtype=getattr(torch, dtype))
    batch = jlm.synthetic_batch(jcfg, 2, 8) if with_batch else None
    jspec = JAutoDist(strategy_builder=JParallax())._model_spec_for(
        jlm.make_loss_fn(jlm.TransformerLM(jcfg)), _jax_params(), batch, None)
    tspec = AutoDist._model_spec_for(tlm.make_loss_fn(tlm.TransformerLM(tcfg)),
                                     from_jax_params(_jax_params()), batch, None)
    assert _flags(tspec) == _flags(jspec)
    want = {"bfloat16": ["pos_embed"], "float32": ["embed/embedding", "pos_embed"]}
    assert sorted(n for n, p in tspec.params.items() if p.sparse) == \
        (want[dtype] if with_batch else [])
    assert _parallax(tspec, "torch") == _parallax(jspec, "jax")


def test_sparse_names_win_and_tokens_index_leaf():
    """``sparse_names`` overrides the walk (no index leaf, as in JAX); the
    sentiment loss's table is sparse with the index leaf ``tokens``, and a
    loss whose gather reads transformed indices has no leaf."""
    from autodist_tpu.model_spec import ModelSpec as JModelSpec

    rng = np.random.RandomState(0)
    params = {"embedding": rng.randn(50, 8).astype(np.float32),
              "w": rng.randn(8, 1).astype(np.float32), "b": np.zeros((1,), np.float32)}
    batch = {"tokens": rng.randint(0, 50, (4, 6)).astype(np.int32),
             "labels": rng.randint(0, 2, (4,)).astype(np.int32)}

    def jloss(p, b):
        pooled = jnp.take(p["embedding"], b["tokens"], axis=0).mean(axis=1)
        return jnp.mean((pooled @ p["w"] + p["b"])[:, 0] - b["labels"])

    def tloss(p, b):
        pooled = p["embedding"][b["tokens"].long()].mean(1)
        return ((pooled @ p["w"] + p["b"])[:, 0] - b["labels"]).mean()

    def shifted(p, b):
        return torch.nn.functional.embedding(b["tokens"].long() + 1, p["embedding"]).sum()

    tparams = {k: torch.tensor(v) for k, v in params.items()}
    jspec = JModelSpec.from_loss_fn(jloss, params, batch)
    tspec = ModelSpec.from_loss_fn(tloss, tparams, batch)
    assert _flags(tspec) == _flags(jspec)
    assert tspec["embedding"].index_leaf == "tokens" and tspec["embedding"].sparse
    assert _parallax(tspec, "torch") == _parallax(jspec, "jax")
    named = AutoDist._model_spec_for(tloss, tparams, batch, ["w"])
    assert _flags(named) == {"b": (False, None), "embedding": (False, None),
                             "w": (True, None)}
    assert _flags(ModelSpec.from_loss_fn(shifted, tparams, batch))["embedding"] == \
        (True, None)


def test_flagship_entry_point_spec_matches_bench():
    """``flagship_lm.build`` hands the walk a micro-batch, as ``bench.py``'s
    flagship hands it its batch: the runner's plan carries the JAX
    package's sparse flags (f32 on the host: both tables sparse, no index
    leaf for the positional slice)."""
    from autodist_tpu_torch.examples import flagship_lm

    widths = dict(vocab_size=64, d_model=32, n_layers=1)
    args = flagship_lm.parse_args(
        ["--device", "cpu", "--micro_batch", "2", "--seq_len", "8", "--accum", "2",
         "--d_model", str(widths["d_model"]), "--n_layers", str(widths["n_layers"]),
         "--vocab", str(widths["vocab_size"])])
    _, step, _ = flagship_lm.build(args)
    # bench.py's flagship at these widths: n_heads 8, d_ff 4 d, max_len 512.
    jcfg = jlm.TransformerLMConfig(**widths, n_heads=8, d_ff=4 * widths["d_model"],
                                   max_len=512, dtype=jnp.float32, tied_output=False,
                                   fused_head=True)
    jmodel, jparams = jlm.init_params(jcfg)
    batch = jlm.synthetic_batch(jcfg, batch_size=2 * 2, seq_len=8)
    jspec = JAutoDist(strategy_builder=JAllReduce())._model_spec_for(
        jlm.make_loss_fn(jmodel), jparams, batch, None)
    plan = step.runner.plan.params
    assert {n: (p.sparse, p.index_leaf) for n, p in plan.items()} == _flags(jspec)
    assert sorted(n for n, p in plan.items() if p.sparse) == ["embed/embedding", "pos_embed"]


def _heads(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["lse_dv", "lse_vd", "xent_dv", "xent_vd", "flash",
                                  "flash_carry"])
def test_kernel_plain_versions_read_tables_whole(case):
    """The walk counts a slice as a gather, so each kernel wrapper's plain
    version (what the walk traces on its CPU fakes) must read a parameter
    table whole: a table that only a kernel reads is dense, as an operand
    of ``pallas_call`` is in the JAX package. The fused head's table spans
    several of the plain version's vocab chunks."""
    rng = np.random.RandomState(0)
    if case.startswith(("lse", "xent")):
        layout = case[-2:]
        v, d = 2 * fx.PLAIN_V_CHUNK + 100, 8
        params = {"w": _heads(rng, *((d, v) if layout == "dv" else (v, d))),
                  "b": _heads(rng, v)}
        batch = {"h": _heads(rng, 4, d), "targets": rng.randint(0, v, 4)}

        def loss(p, b):
            if case.startswith("lse"):
                return fx.matmul_logsumexp(b["h"], p["w"], p["b"], layout).sum()
            return fx.fused_softmax_xent(b["h"], p["w"], b["targets"].long(), p["b"],
                                         layout).sum()
    else:
        shape = (1, 2 * fa.PLAIN_K_BLOCK + 8, 2, 8)
        params = {"k": _heads(rng, *shape)}
        batch = {"q": _heads(rng, *shape), "v": _heads(rng, *shape)}

        def loss(p, b):
            if case == "flash":
                return fa.flash_attention(b["q"], p["k"], b["v"]).sum()
            return fa.flash_attention_with_carry(b["q"], p["k"], b["v"])[0].sum()

    spec = ModelSpec.from_loss_fn(loss, {k: torch.tensor(a) for k, a in params.items()},
                                  batch)
    assert not any(p.sparse for p in spec.params.values()), _flags(spec)
