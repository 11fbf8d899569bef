"""The port's ImageNet input plane (autodist_tpu_torch.data.imagenet) against
the JAX package's, on the host: record shards from a tiny PIL-written image
tree (prepared byte for byte as JAX prepares them), ``augment_images``,
``AugmentingBatcher``, ``DeviceDatasetCache`` (its pool, refresh and
assembled batches, from the same loader rows and seed) and the augmented
loss. Everything is exact (atol 0): the plane copies bytes, and its only
arithmetic, one f32 subtraction of the channel means, rounds the same way
in both; the augmented loss takes rtol 1e-5, as the model tests do.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from autodist_tpu.data import imagenet as jimagenet
from autodist_tpu_torch.data import imagenet as timagenet
from test_image_data import _write_tree


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """``(port shard dir, JAX shard dir)``: 48 records of 32 px, 3 classes."""
    root = tmp_path_factory.mktemp("images")
    _write_tree(str(root / "tree"), n_classes=3, per_class=16)
    tpaths = timagenet.prepare_image_shards(str(root / "tree"), str(root / "t"),
                                            record_size=32, rows_per_shard=20)
    jpaths = jimagenet.prepare_image_shards(str(root / "tree"), str(root / "j"),
                                            record_size=32, rows_per_shard=20)
    return root / "t", root / "j", tpaths, jpaths


def test_prepare_image_shards_equal_jax(shards):
    tdir, jdir, tpaths, jpaths = shards
    for key in ("images", "labels"):
        assert [pathlib.Path(p).name for p in tpaths[key]] == \
            [pathlib.Path(p).name for p in jpaths[key]]
        for a, b in zip(tpaths[key], jpaths[key]):
            assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    assert timagenet.read_meta(str(tdir)) == jimagenet.read_meta(str(jdir)) == \
        json.loads((tdir / timagenet.META_NAME).read_text())
    assert timagenet.read_meta(str(tdir / "nowhere")) is None
    with pytest.raises(FileNotFoundError, match="images-meta.json"):
        timagenet.open_image_loader(str(tdir / "nowhere"), 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_images_equal_jax(dtype):
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (5, 12, 12, 3)).astype(np.uint8)
    crop = rng.randint(0, 5, (5, 2)).astype(np.int32)
    flip = np.array([True, False, True, True, False])
    want = np.asarray(jimagenet.augment_images(images, crop, flip, 8,
                                               getattr(jnp, dtype)).astype(jnp.float32))
    got = timagenet.augment_images(torch.tensor(images), torch.tensor(crop),
                                   torch.tensor(flip), 8, getattr(torch, dtype))
    assert got.shape == (5, 8, 8, 3) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("train", [True, False])
def test_augmenting_batcher_equal_jax(shards, train):
    tdir, jdir, _, _ = shards
    tl, _ = timagenet.open_image_loader(str(tdir), 8, seed=3)
    jl, _ = jimagenet.open_image_loader(str(jdir), 8, seed=3)
    tb = timagenet.AugmentingBatcher(tl, image_size=24, record_size=32, train=train, seed=2)
    jb = jimagenet.AugmentingBatcher(jl, image_size=24, record_size=32, train=train, seed=2)
    try:
        for _ in range(3):
            got, want = tb.next(), jb.next()
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    finally:
        tl.close(), jl.close()
    with pytest.raises(ValueError, match="exceeds record_size"):
        timagenet.AugmentingBatcher(tl, image_size=64, record_size=32)


def test_device_dataset_cache_equal_jax(shards):
    """A 32-row pool over 48 records, refreshing 8 rows every 2 steps: the
    pool, the labels and every assembled batch equal JAX's; the refresh has
    replaced pool rows by the end."""
    tdir, jdir, _, _ = shards
    kw = dict(record_size=32, image_size=24, pool_rows=32, refresh_rows=8,
              refresh_interval=2, seed=7)
    tl, _ = timagenet.open_image_loader(str(tdir), 16, shuffle=False, native=False)
    jl, _ = jimagenet.open_image_loader(str(jdir), 16, shuffle=False, native=False)
    tcache = timagenet.DeviceDatasetCache(tl, device="cpu", **kw)
    jcache = jimagenet.DeviceDatasetCache(jl, **kw)
    assert tcache.pool_rows == jcache.pool_rows == 32
    before = tcache._pool.clone()
    try:
        for _ in range(13):
            got, want = tcache.next_batch(6), jcache.next_batch(6)
            np.testing.assert_array_equal(got["images"].numpy(), np.asarray(want["images"]))
            np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(tcache._pool.numpy(), np.asarray(jcache._pool))
        assert not torch.equal(tcache._pool, before)
    finally:
        tl.close(), jl.close()
    # A pool holding every servable row stops refreshing.
    tl, _ = timagenet.open_image_loader(str(tdir), 16, shuffle=False, native=False)
    full = timagenet.DeviceDatasetCache(tl, record_size=32, image_size=32,
                                        refresh_interval=1, device="cpu")
    pool = full._pool.clone()
    for _ in range(4):
        full.next_batch(4)
    assert full.pool_rows == 48 and torch.equal(full._pool, pool)
    tl.close()


def test_augmented_loss_equals_jax(shards):
    """``make_augmented_loss_fn`` over a raw record batch, a tiny ResNet."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.models import resnet as jresnet
    from autodist_tpu_torch import to_jax_params
    from autodist_tpu_torch.models import layers, resnet

    small = dict(num_classes=3, stage_sizes=(1,), width=8)
    tmodel = resnet.ResNet(resnet.ResNet50Config(**small, dtype=torch.float32))
    params = layers.init_params(tmodel, seed=0, device="cpu")
    tdir, jdir, _, _ = shards
    tl, _ = timagenet.open_image_loader(str(tdir), 4, seed=1, native=False)
    batch = timagenet.AugmentingBatcher(tl, image_size=24, record_size=32).next()
    tl.close()
    jmodel = jresnet.ResNet(jresnet.ResNet50Config(**small, dtype=jnp.float32))
    want = jax.jit(jimagenet.make_augmented_loss_fn(jmodel, 24))(to_jax_params(params),
                                                                  batch)
    got = timagenet.make_augmented_loss_fn(tmodel, 24)(
        params, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_benchmark_prepares_trains_and_evaluates(tmp_path):
    """``examples/benchmark/imagenet`` on the host: ``--prep_images`` writes
    the record shards JAX writes; training from them in both input modes
    runs and reports; ``--eval`` (with ``--bn_ema`` on a sync-BN model)
    scores one pass."""
    from autodist_tpu_torch.examples.benchmark import imagenet as bench

    _write_tree(str(tmp_path / "tree"), n_classes=3, per_class=4)
    data = str(tmp_path / "records")
    assert bench.main(["--prep_images", str(tmp_path / "tree"), "--data_dir", data,
                       "--record_size", "32"]) == 0
    assert timagenet.read_meta(data)["rows"] == 12
    tiny = ["--device", "cpu", "--stages", "1", "--image_size", "24", "--batch_size", "4",
            "--data_dir", data]
    for mode in ("cache", "stream"):
        result = bench.main(tiny + ["--input_mode", mode, "--steps", "2"])
        assert result["source"] == "disk" and np.isfinite(result["final_loss"])
        assert result["mfu"] is None and result["images_per_sec"] > 0
    top1 = bench.main(tiny + ["--eval", "--norm", "batch", "--bn_ema", "1"])
    assert 0.0 <= top1 <= 1.0
