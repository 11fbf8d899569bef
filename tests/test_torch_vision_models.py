"""The port's ResNet (autodist_tpu_torch.models.resnet, on the flax layers
of models/layers.py) against the JAX package's flax model: with the same
weights and a batch from one seed, the f32 loss and every gradient, under
GroupNorm and sync-BN; ``calibrate_bn_ema``; and the paddings themselves.
tests/test_torch_vision_zoo.py holds the rest of the zoo the same way. The
weights are drawn once by the port's initializer from a seed and handed to
flax as its params tree (``to_jax_params``), which spares the JAX init's
compile; the gradients flax returns come back through ``from_jax_params``
and must name exactly the port's parameters.

Image sizes: an even one, where every stride-2 "SAME" conv and pool pads
asymmetrically (64: the 7x7/2 stem pads 2 before and 3 after), and an odd
one (33). At these tiny widths the last stage sees 2 x 2
pixels; at 32 x 32 it would see one, and a norm's variance over two values
leaves the gradient to the summation order.

Tolerances, the same math in two summation orders: the loss rtol 1e-5, the
gradients rtol 2e-4 / atol 2e-5 (tests/test_sequence_parallel.py:40-63).
Sync-BN runs on 2 gloo ranks in one spawn (each child runs this file as a
script and imports torch and the port only), each rank on half of the
batch, against JAX's statistics over the whole batch.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist, from_jax_params, to_jax_params
from autodist_tpu_torch.models import layers, resnet
from test_torch_ring_attention import join_gloo_group, ranks_running

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
TWO_GPUS = {"nodes": [{"address": "localhost", "gpus": [0, 1]}]}
RESNET = dict(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8)


def _torch_grads(loss_fn, params, batch):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, {k: torch.tensor(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {k: v.grad for k, v in leaves.items()}


def _assert_matches_jax(jloss_fn, tloss_fn, tmodel, batch):
    """The loss and gradients of ``jloss_fn`` and ``tloss_fn`` at the port's
    initial weights for ``tmodel``."""
    import jax
    import jax.numpy as jnp
    params = layers.init_params(tmodel, seed=1, device="cpu")
    loss, grads = jax.jit(jax.value_and_grad(jloss_fn))(
        to_jax_params(params), {k: jnp.asarray(v) for k, v in batch.items()})
    want = from_jax_params(jax.device_get(grads))
    got_loss, got = _torch_grads(tloss_fn, params, batch)
    assert set(got) == set(want)
    np.testing.assert_allclose(got_loss, float(loss), **LOSS)
    for key, g in want.items():
        np.testing.assert_allclose(got[key].numpy(), g.numpy(), err_msg=key, **GRAD)


def _resnets(norm):
    """``(JAX config, flax model, port model)``, f32."""
    import jax.numpy as jnp
    from autodist_tpu.models import resnet as jresnet
    cfg = jresnet.ResNet50Config(**RESNET, dtype=jnp.float32, norm=norm)
    tmodel = resnet.ResNet(resnet.ResNet50Config(**RESNET, dtype=torch.float32, norm=norm))
    return cfg, jresnet.ResNet(cfg), tmodel


@pytest.mark.parametrize("size", [64, 33])
@pytest.mark.parametrize("norm", ["group", "batch"])
def test_resnet_matches_jax(norm, size):
    from autodist_tpu.models import resnet as jresnet
    cfg, jmodel, tmodel = _resnets(norm)
    _assert_matches_jax(jresnet.make_loss_fn(jmodel), resnet.make_loss_fn(tmodel), tmodel,
                        jresnet.synthetic_batch(cfg, 2, size))


def test_calibrate_bn_ema_matches_jax():
    """The ``bn_ema`` collection from two calibration batches equals JAX's,
    key for key; an EMA-reading model over one batch's statistics gives that
    batch's logits (tests/test_models.py:115-138)."""
    import dataclasses

    import jax
    from autodist_tpu.models import resnet as jresnet
    _, jmodel, model = _resnets("batch")
    params = layers.init_params(model, seed=1, device="cpu")
    rng = np.random.RandomState(4)
    batches = [rng.randn(3, 33, 33, 3).astype(np.float32) for _ in range(2)]
    want = from_jax_params(jax.device_get(
        jresnet.calibrate_bn_ema(jmodel, to_jax_params(params), batches)))
    cfg = model.config
    got = resnet.calibrate_bn_ema(model, params, [torch.tensor(b) for b in batches])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **GRAD)
    one = resnet.calibrate_bn_ema(model, params, [torch.tensor(batches[0])])
    eval_model = resnet.ResNet(dataclasses.replace(cfg, bn_ema=True))
    with torch.no_grad():
        y_ema = resnet.apply(eval_model, params, torch.tensor(batches[0]), bn_ema=one)
        y_batch = resnet.apply(model, params, torch.tensor(batches[0]))
        y_one = resnet.apply(eval_model, params, torch.tensor(batches[0][:1]), bn_ema=one)
    torch.testing.assert_close(y_ema, y_batch, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y_one[0], y_ema[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="batch-stats model"):
        resnet.calibrate_bn_ema(eval_model, params, [batches[0]])


def test_same_padding_and_pools_follow_xla():
    """The paddings themselves: "SAME" splits with the extra row after the
    data; max pools pad with -inf; average pools count the padded zeros."""
    assert layers.same_pads(224, 7, 2) == (2, 3)
    assert layers.same_pads(112, 3, 2) == (0, 1)
    assert layers.same_pads(33, 3, 2) == (1, 1)
    x = -torch.ones((1, 1, 2, 2))
    assert torch.equal(layers.max_pool(x, 3, strides=2, padding="SAME"), -torch.ones(1, 1, 1, 1))
    y = layers.avg_pool(torch.ones((1, 1, 3, 3)), 3, strides=1, padding="SAME")
    assert float(y[0, 0, 0, 0]) == pytest.approx(4 / 9)


# ------------------------------------------------------------------ sync-BN

def _sync_bn_worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    params = {k: torch.tensor(v) for k, v in np.load(workdir / "params.npz").items()}
    batch = {k: torch.tensor(v) for k, v in np.load(workdir / "batch.npz").items()}
    model = resnet.ResNet(resnet.ResNet50Config(**RESNET, dtype=torch.float32, norm="batch"))
    ad = AutoDist(resource_info=TWO_GPUS, strategy_builder=AllReduce(), device="cpu")
    runner = ad.create_distributed_session(resnet.make_loss_fn(model), params,
                                           lambda p: torch.optim.SGD(p, lr=0.05))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads, loss, _ = runner._grad_fn(leaves, runner.shard_batch(batch))
    np.savez(workdir / f"bn_rank{dist.get_rank()}.npz", loss=loss.detach().numpy(),
             **{f"grad-{k}": g.numpy() for k, g in grads.items()})
    dist.destroy_process_group()


def test_two_rank_sync_batchnorm_uses_global_statistics(tmp_path):
    """Each of 2 ranks holds 2 of the 4 images; the loss and synchronized
    gradients equal JAX's on the whole batch (per-rank statistics would
    not)."""
    import jax
    from autodist_tpu.models import resnet as jresnet
    cfg, jmodel, tmodel = _resnets("batch")
    params = layers.init_params(tmodel, seed=1, device="cpu")
    batch = jresnet.synthetic_batch(cfg, 4, 33, seed=5)
    np.savez(tmp_path / "params.npz", **{k: v.numpy() for k, v in params.items()})
    np.savez(tmp_path / "batch.npz", **batch)
    with ranks_running(pathlib.Path(__file__), 2, "sync_bn", tmp_path) as wait:
        loss, grads = jax.jit(jax.value_and_grad(jresnet.make_loss_fn(jmodel)))(
            to_jax_params(params), batch)
        want = from_jax_params(jax.device_get(grads))
        wait()
    for rank in range(2):
        got = np.load(tmp_path / f"bn_rank{rank}.npz")
        np.testing.assert_allclose(got["loss"], float(loss), **LOSS)
        for key, g in want.items():
            np.testing.assert_allclose(got[f"grad-{key}"], g.numpy(), err_msg=key, **GRAD)


if __name__ == "__main__":
    if sys.argv[1] == "sync_bn":
        _sync_bn_worker(pathlib.Path(sys.argv[2]))
