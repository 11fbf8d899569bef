"""The port's AutoDist path against the JAX package's: model spec, strategy,
and a short training run with gradient accumulation, on the small
TransformerLM with the fused head. Also the port's import boundary.

Inputs and weights are made once with numpy (the flax init, as numpy arrays)
and fed to both packages. Both sides train in f32; the tolerances (losses
rtol 1e-4, params atol 1e-5 after three Adam steps) leave room for the two
frameworks' summation orders, which Adam's normalised update can amplify
where a gradient is near zero.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from google.protobuf.json_format import MessageToDict

import autodist_tpu
import autodist_tpu_torch
from autodist_tpu.model_spec import ModelSpec as JModelSpec
from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AutoDist, from_jax_params, to_jax_params
from autodist_tpu_torch.model_spec import ModelSpec
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

SMALL = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32)
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
BATCH, SEQ, ACCUM, STEPS = 16, 16, 2, 3


@functools.cache
def _jax_params(tied):
    cfg = jlm.TransformerLMConfig(**SMALL, tied_output=tied, dtype=jnp.float32)
    return jax.device_get(jlm.init_params(cfg, jax.random.PRNGKey(1))[1])


def _models(tied, attention_impl="dot", remat=False):
    extra = dict(attention_impl=attention_impl, remat=remat)
    jcfg = jlm.TransformerLMConfig(**SMALL, tied_output=tied, fused_head=True,
                                   dtype=jnp.float32, **extra)
    tcfg = tlm.TransformerLMConfig(**SMALL, tied_output=tied, fused_head=True,
                                   dtype=torch.float32, **extra)
    return jlm.TransformerLM(jcfg), _jax_params(tied), tlm.TransformerLM(tcfg)


def _batches():
    cfg = jlm.TransformerLMConfig(**SMALL)
    return [jlm.synthetic_batch(cfg, BATCH, SEQ, seed=10 + i) for i in range(STEPS)]


@pytest.mark.parametrize("tied", [False, True])
def test_model_spec_and_strategy_match_jax(tied):
    jmodel, jparams, tmodel = _models(tied)
    batch = _batches()[0]
    jspec = JModelSpec.from_loss_fn(jlm.make_loss_fn(jmodel), jparams, batch)
    tspec = ModelSpec.from_loss_fn(tlm.make_loss_fn(tmodel), from_jax_params(jparams), batch)
    assert tspec.names == jspec.names
    assert {n: p.sparse for n, p in tspec.params.items()} == \
        {n: p.sparse for n, p in jspec.params.items()}
    assert {n: p.shape for n, p in tspec.params.items()} == \
        {n: p.shape for n, p in jspec.params.items()}

    want = MessageToDict(JAllReduce(chunk_size=7).build(
        jspec, JResourceSpec(resource_info=ONE_GPU)).proto,
        preserving_proto_field_name=True)
    got = AllReduce(chunk_size=7).build(tspec, ResourceSpec(resource_info=ONE_GPU)).to_dict()
    want.pop("id"), got.pop("id")    # build timestamps
    assert got == want


def _run_jax(jmodel, jparams, batches):
    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE_GPU), JAllReduce())
    step = ad.function(jlm.make_loss_fn(jmodel), jparams, optax.adam(1e-3),
                       example_batch=batches[0], accumulation_steps=ACCUM)
    losses = [float(step(b)) for b in batches]
    return losses, jax.device_get(step.runner.logical_params(step.get_state()))


def _run_torch(tmodel, jparams, batches):
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=AllReduce(), device="cpu")
    step = ad.function(tlm.make_loss_fn(tmodel), from_jax_params(jparams),
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                       example_batch=batches[0], accumulation_steps=ACCUM)
    losses = [float(step(b)) for b in batches]
    return losses, to_jax_params(step.get_state().params), step


@pytest.mark.parametrize("attention_impl,remat", [("dot", False), ("flash", True)])
def test_training_tracks_jax_with_accumulation(attention_impl, remat):
    """Three Adam steps with 2-way accumulation: the flagship step, and its
    long-context form (flash attention, rematerialized blocks)."""
    jmodel, jparams, tmodel = _models(tied=False, attention_impl=attention_impl,
                                      remat=remat)
    batches = _batches()
    want_losses, want_params = _run_jax(jmodel, jparams, batches)
    got_losses, got_params, step = _run_torch(tmodel, jparams, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    flat_got = jax.tree_util.tree_leaves_with_path(got_params)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_got:
        np.testing.assert_allclose(value, flat_want[path], rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # The params moved, and the caller's weights were not updated in place.
    assert not np.allclose(got_params["lm_head"]["kernel"], jparams["lm_head"]["kernel"])
    assert step.get_state().step == STEPS
    # Evaluation reads the trained params and changes nothing.
    before = float(step.evaluate(batches[0]))
    assert float(step.evaluate(batches[0])) == before


def test_accumulation_equals_full_batch():
    """k micro-batches of B/k make the same update as one batch of B
    (runner.py's MicroBatched contract): same loss, same params."""
    _, jparams, tmodel = _models(tied=True)
    batches = _batches()[:1]
    runs = []
    for k in (1, 4):
        ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
        step = ad.function(tlm.make_loss_fn(tmodel), from_jax_params(jparams),
                           lambda p: torch.optim.SGD(p, lr=0.1), accumulation_steps=k)
        runs.append((float(step(batches[0])), step.get_state().params))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for key, value in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][key], value, rtol=1e-5, atol=1e-6)


def test_long_context_entry_point_runs_on_the_host(capsys):
    """``python -m autodist_tpu_torch.examples.long_context_lm`` at a tiny size
    with ``--device cpu``: flash (the default), remat and the fused head
    through AutoDist.function; it prints the result line and no device
    metric. ``--seq_axis 2`` takes no other attention, and in a process
    without a group of 2 ranks it raises instead of running alone."""
    from autodist_tpu_torch.examples import long_context_lm

    rate = long_context_lm.main(["--device", "cpu", "--seq_len", "32", "--batch_size", "2",
                                 "--d_model", "64", "--n_layers", "1", "--vocab", "128",
                                 "--steps", "1"])
    out = capsys.readouterr().out
    assert rate > 0
    assert "long-context seq=32 bs=2 attention=flash remat=True" in out
    assert "final loss" in out and "mfu not measured" in out
    with pytest.raises(SystemExit):
        long_context_lm.parse_args(["--seq_axis", "2", "--attention", "flash"])
    assert "cannot honor --attention flash" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="seq axis has 2 ranks but the seq group has 1"):
        long_context_lm.main(["--device", "cpu", "--seq_axis", "2", "--seq_len", "32",
                              "--d_model", "64", "--n_layers", "1", "--vocab", "128"])
    args = long_context_lm.parse_args([])
    assert (args.seq_len, args.d_model, args.n_layers, args.vocab) == (8192, 512, 6, 32_000)
    cfg, _, batch = long_context_lm.build(long_context_lm.parse_args(
        ["--device", "cpu", "--seq_len", "4096", "--n_layers", "1", "--vocab", "64",
         "--d_model", "64", "--no_remat", "--attention", "blockwise"]))
    assert batch["tokens"].shape == (393_216 // 4096, 4097)
    assert (cfg.remat, cfg.attention_impl, cfg.fused_head, cfg.tied_output) == \
        (False, "blockwise", True, False)


def test_batch_split_errors():
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    _, jparams, tmodel = _models(tied=True)
    runner = ad.create_distributed_session(
        tlm.make_loss_fn(tmodel), from_jax_params(jparams),
        lambda p: torch.optim.SGD(p, lr=0.1), accumulation_steps=3)
    with pytest.raises(ValueError, match="not divisible|Cannot infer"):
        runner.shard_batch({"tokens": np.zeros((16, 5), np.int32)})
    micro = runner.shard_batch({"tokens": np.arange(12 * 5).reshape(12, 5)})["tokens"]
    assert tuple(micro.value.shape) == (3, 4, 5)
    assert int(micro.value[1, 0, 0]) == 4 * 5        # contiguous split


def test_default_device_is_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoDist()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(tlm.TransformerLMConfig(**SMALL))


def test_more_than_one_replica_is_not_ported_yet():
    """Two data replicas without a process group of two ranks never train
    alone (tests/test_torch_data_parallel.py runs them over 2 gloo ranks)."""
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0, 1]}]},
                  device="cpu")
    _, jparams, tmodel = _models(tied=True)
    with pytest.raises(RuntimeError, match="data axes have 2 ranks but the data group has 1"):
        ad.create_distributed_session(tlm.make_loss_fn(tmodel), from_jax_params(jparams),
                                      lambda p: torch.optim.SGD(p, lr=0.1))


def test_resource_spec_yaml_and_dict_agree(tmp_path):
    text = "nodes:\n  - address: 10.0.0.1\n    gpus: [0, 1]\n    chief: true\n"
    path = tmp_path / "spec.yml"
    path.write_text(text)
    for spec in (ResourceSpec(text), ResourceSpec(str(path)),
                 ResourceSpec(resource_info={"nodes": [{"address": "10.0.0.1",
                                                        "gpus": [0, 1]}]})):
        assert [d.name_string for d in spec.replica_devices] == \
            ["10.0.0.1:GPU:0", "10.0.0.1:GPU:1"]
        assert spec.chief_address == "10.0.0.1"


_PORT = pathlib.Path(autodist_tpu_torch.__file__).parent
# Neither ml_dtypes nor google.protobuf is on the card's machine.
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "autodist_tpu", "ml_dtypes", "google")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node, node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted(_PORT.rglob("*.py"))
    assert len(files) > 15
    # The operator tools and the analyzer are the port's too; so is the
    # card's smoke script.
    assert {"analysis", "tools"} <= {p.relative_to(_PORT).parts[0] for p in files}
    files.append(_PORT.parent / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        top_level = {id(n) for n in tree.body}
        for node, name in _imports(tree):
            root = name.split(".")[0]
            assert root not in _FORBIDDEN, f"{path.relative_to(_PORT)} imports {name}"
            assert root != "google", f"{path.relative_to(_PORT)} imports {name}"
            # PyYAML is not on the card's machine: only the YAML branch imports it.
            if root == "yaml":
                assert id(node) not in top_level, f"{path} imports yaml at top level"
