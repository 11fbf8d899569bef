"""The port's Saver (autodist_tpu_torch.checkpoint.saver) against the JAX
package's, on the small TransformerLM with the fused head and Adam(1e-3):
checkpoints cross-restore between the two packages bit for bit, in both
directions and both JAX formats (single-file v1, sharded v2), under the JAX
names; after a restore one more step in each package agrees; rotation, the
per-name ``checkpoint`` state file and async writes behave as the JAX
Saver's.

Everything is f32. After a restore and one Adam step: the losses rtol 1e-4
and the params atol 1e-5 (tests/test_torch_sequence_parallel.py's
tolerances after Adam steps).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu
from autodist_tpu.checkpoint.saver import Saver as JSaver
from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AllReduce, AutoDist, from_jax_params
from autodist_tpu_torch.checkpoint.saver import Saver, checkpoint_exists
from autodist_tpu_torch.models import transformer_lm as tlm

SMALL = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
BATCH, SEQ = 4, 16


def _config(module, dtype):
    return module.TransformerLMConfig(**SMALL, dtype=dtype, tied_output=False,
                                      fused_head=True)


@functools.cache
def _jax_params():
    return jax.device_get(jlm.init_params(_config(jlm, jnp.float32), jax.random.PRNGKey(7))[1])


def _batch(seed):
    return jlm.synthetic_batch(_config(jlm, jnp.float32), BATCH, SEQ, seed=seed)


def _jax_step():
    ad = autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE_GPU), JAllReduce())
    return ad.function(jlm.make_loss_fn(jlm.TransformerLM(_config(jlm, jnp.float32))),
                       _jax_params(), optax.adam(1e-3))


def _torch_runner(optimizer=lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8)):
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=AllReduce(), device="cpu")
    model = tlm.TransformerLM(_config(tlm, torch.float32))
    return ad.create_distributed_session(tlm.make_loss_fn(model),
                                         from_jax_params(_jax_params()), optimizer)


def _jax_flat(step):
    """``{port state-dict key: array}`` of a JAX step's params, mu and nu,
    plus its count and step."""
    state = step.get_state()
    adam = state.opt_state[0]
    out = {f"param-{k}": v.numpy() for k, v in
           from_jax_params(jax.device_get(step.runner.logical_params(state))).items()}
    for field in ("mu", "nu"):
        out.update({f"{field}-{k}": v.numpy() for k, v in
                    from_jax_params(jax.device_get(getattr(adam, field))).items()})
    out["count"] = np.asarray(jax.device_get(adam.count))
    out["step"] = np.asarray(int(state.step))
    return out


def _torch_flat(state):
    out = {}
    for key, p in state.params.items():
        out[f"param-{key}"] = p.detach().numpy()
        st = state.optimizer.state[p]
        out[f"mu-{key}"] = st["exp_avg"].numpy()
        out[f"nu-{key}"] = st["exp_avg_sq"].numpy()
        count = int(st["step"])
    out["count"] = np.asarray(count, np.int32)
    out["step"] = np.asarray(state.step)
    return out


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].dtype == value.dtype or key == "step", key


@pytest.fixture(scope="module")
def jax_trained():
    """A JAX run of 2 Adam steps."""
    step = _jax_step()
    for seed in (1, 2):
        step(_batch(seed))
    return step


@pytest.mark.parametrize("sharded", [False, True])
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(jax_trained, tmp_path, sharded):
    """A JAX Saver checkpoint (v1, and v2 written with ``sharded=True``) into
    a port runner: params, Adam mu/nu, count and step, bit for bit; then one
    more step in each package agrees."""
    prefix = JSaver().save(jax_trained.get_state(), str(tmp_path / "model"),
                           runner=jax_trained.runner, sharded=sharded)
    assert os.path.exists(prefix + (".json" if sharded else ".npz"))
    runner = _torch_runner()
    latest = Saver.latest_checkpoint(str(tmp_path), name="model")
    assert latest == prefix and checkpoint_exists(latest)
    state = Saver().restore(latest, runner=runner)
    _assert_bit_equal(_torch_flat(state), _jax_flat(jax_trained))
    assert Saver().restore_params(prefix).keys() == state.params.keys()

    batch = _batch(3)
    _, loss = runner.run(state, batch)
    want = float(_jax_step_after(jax_trained, batch))
    np.testing.assert_allclose(float(loss), want, rtol=1e-4)


def _jax_step_after(step, batch):
    """One more step of a copy of ``step``'s state (the fixture stays put)."""
    runner = step.runner
    state = jax.tree_util.tree_map(jnp.copy, step.get_state())
    _, loss = runner.run(state, batch)
    return loss


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    """A port checkpoint into the JAX Saver: JAX's ``latest_checkpoint``
    finds it, and params, mu/nu, count and step come back bit for bit;
    one more step in each agrees within the tolerances."""
    runner = _torch_runner()
    state = runner.init(from_jax_params(_jax_params()))
    for seed in (1, 2):
        runner.run(state, _batch(seed))
    prefix = Saver().save(state, str(tmp_path / "model"))
    assert prefix == str(tmp_path / "model-2")
    jstep = _jax_step()
    latest = JSaver.latest_checkpoint(str(tmp_path), name="model")
    assert latest == prefix
    jstate = JSaver().restore(latest, runner=jstep.runner)
    adam = jstate.opt_state[0]
    want = _torch_flat(state)
    got = {f"param-{k}": v.numpy() for k, v in
           from_jax_params(jax.device_get(jstate.params)).items()}
    for field in ("mu", "nu"):
        got.update({f"{field}-{k}": v.numpy() for k, v in
                    from_jax_params(jax.device_get(getattr(adam, field))).items()})
    got["count"] = np.asarray(jax.device_get(adam.count))
    got["step"] = np.asarray(int(jstate.step))
    _assert_bit_equal(got, want)

    batch = _batch(3)
    jstate, jloss = jstep.runner.run(jstate, batch)
    _, loss = runner.run(state, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    jparams = from_jax_params(jax.device_get(jstep.runner.logical_params(jstate)))
    for key, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[key].numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)


def test_rotation_and_state_file_merged_per_name(tmp_path):
    """``max_to_keep`` keeps the newest checkpoints of a name; a second name
    in the same directory keeps its own entries in the ``checkpoint`` file,
    as the JAX Saver writes it; bare params save at step 0."""
    runner = _torch_runner()
    state = runner.init(from_jax_params(_jax_params()))
    saver, other = Saver(max_to_keep=2), Saver(max_to_keep=2)
    for step in (1, 2, 3):
        saver.save(state, str(tmp_path / "model"), global_step=step)
    other.save(state.params, str(tmp_path / "ema"))
    files = sorted(os.listdir(tmp_path))
    assert files == ["checkpoint", "ema-0.json", "ema-0.npz", "model-2.json", "model-2.npz",
                     "model-3.json", "model-3.npz"]
    with open(tmp_path / "checkpoint") as f:
        recorded = json.load(f)
    assert recorded == {"latest": str(tmp_path / "ema-0"),
                        "all": [str(tmp_path / "model-2"), str(tmp_path / "model-3"),
                                str(tmp_path / "ema-0")]}
    assert Saver.latest_checkpoint(str(tmp_path), name="model") == str(tmp_path / "model-3")
    assert JSaver.latest_checkpoint(str(tmp_path), name="model") == str(tmp_path / "model-3")
    # A restarted saver adopts the recorded rotation and keeps rotating it.
    Saver(max_to_keep=2).save(state, str(tmp_path / "model"), global_step=4)
    assert not os.path.exists(tmp_path / "model-2.npz")
    assert Saver().restore(str(tmp_path / "ema-0")).keys() == state.params.keys()


def test_async_write_then_wait_and_unported_parts(tmp_path):
    """An async save is on disk once ``wait()`` returns; a sharded write on
    one rank is the v2 format (one shard file and the manifest) and restores
    bit for bit; SGD with momentum (optax.sgd's trace) round-trips in v1 and
    v2; an optimizer without a mapping (Adam with amsgrad) raises."""
    runner = _torch_runner()
    state = runner.init(from_jax_params(_jax_params()))
    runner.run(state, _batch(1))
    saver = Saver()
    prefix = saver.save(state, str(tmp_path / "model"), async_write=True)
    saver.wait()
    assert checkpoint_exists(prefix)
    restored = Saver().restore(prefix, runner=runner)
    _assert_bit_equal(_torch_flat(restored), _torch_flat(state))
    v2 = saver.save(state, str(tmp_path / "v2"), sharded=True)
    assert os.path.exists(v2 + ".shard00000-of-00001.npz") and not os.path.exists(v2 + ".npz")
    assert checkpoint_exists(v2)
    _assert_bit_equal(_torch_flat(Saver().restore(v2, runner=runner)), _torch_flat(state))
    sgd_runner = _torch_runner(lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9))
    sgd = sgd_runner.init(from_jax_params(_jax_params()))
    sgd_runner.run(sgd, _batch(1))
    for sharded in (False, True):
        back = Saver().restore(saver.save(sgd, str(tmp_path / f"sgd{int(sharded)}"),
                                          sharded=sharded), runner=sgd_runner)
        for key, p in sgd.params.items():
            assert torch.equal(back.params[key], p), key
            assert torch.equal(back.optimizer.state[back.params[key]]["momentum_buffer"],
                               sgd.optimizer.state[p]["momentum_buffer"]), key
    state.optimizer = torch.optim.Adam(list(state.params.values()), lr=0.1, amsgrad=True)
    with pytest.raises(NotImplementedError, match="Adam"):
        saver.save(state, str(tmp_path / "model"))
