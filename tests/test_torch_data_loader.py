"""The port's DataLoader (autodist_tpu_torch.data.loader) against the JAX
package's: for the same arrays or shard files and seed, the same batches
bit for bit, on the native path (each package's own build of the same
``loader.cc``) and on the numpy path; ``save_shards`` and
``shard_files_for_process`` name the same files; and ``device_prefetch``
feeds a runner. Exact equality: the loaders copy bytes.
"""

import pathlib

import numpy as np
import pytest
import torch

from autodist_tpu.data import loader as jloader
from autodist_tpu_torch.data import loader as tloader

N_ROWS, BATCH, STEPS = 37, 8, 12     # several epochs, each with a dropped tail


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(N_ROWS, 3, 2).astype(np.float32),
            "y": rng.randint(0, 100, (N_ROWS,)).astype(np.int32),
            "img": rng.randint(0, 256, (N_ROWS, 4, 4, 3)).astype(np.uint8)}


def _batches(loader, n=STEPS):
    try:
        return [loader.next() for _ in range(n)]
    finally:
        loader.close()


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_native_source_is_the_jax_packages():
    assert pathlib.Path(tloader._source_path()).read_bytes() == \
        pathlib.Path(jloader._source_path()).read_bytes()


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_in_memory_batches_equal_jax(native, shuffle):
    kw = dict(batch_size=BATCH, shuffle=shuffle, seed=5, native=native)
    got = tloader.DataLoader(_arrays(), **kw)
    want = jloader.DataLoader(_arrays(), **kw)
    assert got.is_native == want.is_native == native
    _assert_same(_batches(got), _batches(want))


@pytest.mark.parametrize("native", [True, False])
def test_shard_files_equal_jax(tmp_path, native):
    """Shards from both packages' ``save_shards`` (same names), read back
    through ``files=`` whole and split over 2 processes."""
    tfiles = tloader.save_shards(_arrays(1), str(tmp_path / "t"), rows_per_shard=5)
    jfiles = jloader.save_shards(_arrays(1), str(tmp_path / "j"), rows_per_shard=5)
    assert {k: [pathlib.Path(p).name for p in v] for k, v in tfiles.items()} == \
        {k: [pathlib.Path(p).name for p in v] for k, v in jfiles.items()}
    for k in tfiles:
        for a, b in zip(tfiles[k], jfiles[k]):
            assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    kw = dict(batch_size=BATCH, seed=3, native=native)
    _assert_same(_batches(tloader.DataLoader(files=tfiles, **kw)),
                 _batches(jloader.DataLoader(files=jfiles, **kw)))
    for pid in range(2):
        tmine = tloader.shard_files_for_process(tfiles, pid, 2)
        jmine = jloader.shard_files_for_process(jfiles, pid, 2)
        assert {k: [pathlib.Path(p).name for p in v] for k, v in tmine.items()} == \
            {k: [pathlib.Path(p).name for p in v] for k, v in jmine.items()}
        _assert_same(_batches(tloader.DataLoader(files=tmine, batch_size=4, seed=1,
                                                 native=native), 6),
                     _batches(jloader.DataLoader(files=jmine, batch_size=4, seed=1,
                                                 native=native), 6))


def test_errors_and_epochs_match_jax(tmp_path):
    for kwargs in (dict(), dict(arrays=_arrays(), files={}),
                   dict(arrays={"a": np.zeros(3), "b": np.zeros(4)}),
                   dict(arrays=_arrays(), batch_size=N_ROWS + 1)):
        with pytest.raises(ValueError) as want:
            jloader.DataLoader(**kwargs)
        with pytest.raises(ValueError) as got:
            tloader.DataLoader(**kwargs)
        assert str(got.value) == str(want.value)
    files = tloader.save_shards(_arrays(), str(tmp_path), rows_per_shard=20)
    with pytest.raises(ValueError, match="cannot feed 3 processes"):
        tloader.shard_files_for_process(files, 2, 3)
    numpy_path = tloader.DataLoader(_arrays(), batch_size=BATCH, native=False)
    _batches(numpy_path, 10)
    assert numpy_path.epochs_completed == 2       # 4 batches an epoch
    native = tloader.DataLoader(_arrays(), batch_size=BATCH, native=True)
    native.next()
    native.close()
    with pytest.raises(RuntimeError, match="shut down"):
        native.next()


def test_device_prefetch_feeds_a_runner():
    """``device_prefetch`` over the native loader yields the runner's laid
    out batches in the loader's order; ``unroll=2`` yields blocks of two."""
    from autodist_tpu_torch import AllReduce, AutoDist
    from autodist_tpu_torch.runner import ShardedBatch

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce(), device="cpu")
    step = ad.function(lambda p, b: ((b["x"].sum(dim=(1, 2)) * p["w"]) ** 2).mean(),
                       {"w": torch.ones(())}, lambda p: torch.optim.SGD(p, lr=0.01))
    loader = tloader.DataLoader(_arrays(), batch_size=BATCH, seed=2)
    feed = tloader.device_prefetch(loader, step.runner, depth=2)
    try:
        fed = [next(feed) for _ in range(3)]
    finally:
        feed.close()
        loader.close()
    want = _batches(tloader.DataLoader(_arrays(), batch_size=BATCH, seed=2), 3)
    for got, host in zip(fed, want):
        assert isinstance(got, ShardedBatch)
        np.testing.assert_array_equal(got["img"].numpy(), host["img"])
    from autodist_tpu_torch.runner import BatchBlock
    loader = tloader.DataLoader(_arrays(), batch_size=BATCH, seed=2)
    feed = tloader.device_prefetch(loader, step.runner, depth=2, unroll=2)
    try:
        block = next(feed)
    finally:
        feed.close()
        loader.close()
    assert isinstance(block, BatchBlock) and len(block) == 2
    for i, host in enumerate(want[:2]):
        np.testing.assert_array_equal(block.tree["img"][i].numpy(), host["img"])
