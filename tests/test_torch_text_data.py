"""The port's text and recommendation input (autodist_tpu_torch.data:
text_corpus, mlm, movielens), its benchmark logger, and its data package's
exports, against the JAX package's.

Every input is a file this test writes from a numpy seed. The readers are
host numpy in both packages, drawing from the same seeded generators in the
same order, so the results must be equal exactly: vocabularies, shard files,
metadata, masks, ratings splits, negatives and metrics. The logger's files
must carry the JAX package's keys and values (timestamps aside).
"""

import glob
import json
import os

import numpy as np
import pytest

import autodist_tpu.data as jdata
from autodist_tpu.data import mlm as jmlm
from autodist_tpu.data import movielens as jml
from autodist_tpu.data import text_corpus as jtc
from autodist_tpu.utils import benchmark_logger as jlogger
from autodist_tpu_torch.data import mlm as tmlm
from autodist_tpu_torch.data import movielens as tml
from autodist_tpu_torch.data import text_corpus as ttc
from autodist_tpu_torch.utils import benchmark_logger as tlogger

WORDS = [f"w{i}" for i in range(40)]


def _write_corpus(directory, n_files=2, lines=30, seed=0):
    """Zipf-ish words over a few files, lines of uneven length."""
    rng = np.random.RandomState(seed)
    paths = []
    for f in range(n_files):
        path = os.path.join(directory, f"part-{f}.txt")
        with open(path, "w", encoding="utf-8") as out:
            for _ in range(lines):
                n = rng.randint(0, 12)
                ids = np.minimum(rng.zipf(1.5, size=n) - 1, len(WORDS) + 4)
                out.write(" ".join(WORDS[i] if i < len(WORDS) else f"rare{i}"
                                   for i in ids) + "\n")
        paths.append(path)
    return paths


def _shards(directory, key):
    return [np.load(p) for p in sorted(glob.glob(os.path.join(directory, f"{key}-*.npy")))]


def _assert_same_shards(a_dir, b_dir, keys):
    for key in keys:
        a, b = _shards(a_dir, key), _shards(b_dir, key)
        assert len(a) == len(b) and len(a) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_vocabularies_equal_jax(tmp_path):
    paths = _write_corpus(tmp_path)
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("".join(f"{w} {100 - i}\n" for i, w in enumerate(WORDS[:20]))
                          + "\n")
    pairs = [(jtc.load_vocab(str(vocab_file), oov_buckets=3, max_size=15),
              ttc.load_vocab(str(vocab_file), oov_buckets=3, max_size=15)),
             (jtc.build_vocab(paths, max_size=25, oov_buckets=2),
              ttc.build_vocab(paths, max_size=25, oov_buckets=2)),
             (jtc.build_vocab(str(tmp_path / "part-*.txt"), max_size=10),
              ttc.build_vocab(str(tmp_path / "part-*.txt"), max_size=10))]
    probes = WORDS + ["unseen", "rare44", "ünïcode", ""]
    for jv, tv in pairs:
        assert (tv.n_words, tv.oov_buckets, tv.vocab_size, len(tv)) == \
            (jv.n_words, jv.oov_buckets, jv.vocab_size, len(jv))
        assert [tv.lookup(w) for w in probes] == [jv.lookup(w) for w in probes]


@pytest.mark.parametrize("stride", [None, 1, 13])
def test_tokenize_to_shards_equals_jax(tmp_path, stride):
    paths = _write_corpus(tmp_path)
    vocab = jtc.build_vocab(paths, max_size=20, oov_buckets=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpaths = jtc.tokenize_to_shards(paths, vocab, jdir, seq_len=7, rows_per_shard=5,
                                    stride=stride)
    tpaths = ttc.tokenize_to_shards(paths, ttc.build_vocab(paths, max_size=20, oov_buckets=2),
                                    tdir, seq_len=7, rows_per_shard=5, stride=stride)
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    _assert_same_shards(jdir, tdir, ["tokens"])
    assert ttc.read_meta(tdir) == jtc.read_meta(jdir)
    assert ttc.read_meta(str(tmp_path)) is None
    ttc.write_meta(tdir, vocab_size=9, seq_len=3, rows=2, stride=4, oov_buckets=1, key="x")
    jtc.write_meta(jdir, vocab_size=9, seq_len=3, rows=2, stride=4, oov_buckets=1, key="x")
    assert (tmp_path / "torch" / "x-meta.json").read_text() == \
        (tmp_path / "jax" / "x-meta.json").read_text()


@pytest.mark.parametrize("segments", [False, True])
def test_prepare_mlm_shards_equals_jax(tmp_path, segments):
    paths = _write_corpus(tmp_path, lines=60)
    vocab = jtc.build_vocab(paths, max_size=30)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jout = jmlm.prepare_mlm_shards(paths, vocab, jdir, seq_len=12, rows_per_shard=8,
                                   segments=segments, seed=3)
    tout = tmlm.prepare_mlm_shards(paths, ttc.build_vocab(paths, max_size=30), tdir,
                                   seq_len=12, rows_per_shard=8, segments=segments, seed=3)
    assert {k: len(v) for k, v in tout.items()} == {k: len(v) for k, v in jout.items()}
    _assert_same_shards(jdir, tdir, ["tokens", "token_types"])
    assert tmlm.read_meta(tdir) == jmlm.read_meta(jdir)
    assert (tmlm.PAD_ID, tmlm.CLS_ID, tmlm.SEP_ID, tmlm.MASK_ID, tmlm.N_SPECIAL) == \
        (jmlm.PAD_ID, jmlm.CLS_ID, jmlm.SEP_ID, jmlm.MASK_ID, jmlm.N_SPECIAL)


def test_mask_batch_equals_jax_bit_for_bit():
    """Rows with pads, an all-pad row and a row with one maskable token;
    the same PCG64 seed on both sides."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(tmlm.N_SPECIAL, 60, size=(6, 24)).astype(np.int32)
    tokens[:, 0] = tmlm.CLS_ID
    tokens[1, 15:] = tmlm.PAD_ID
    tokens[3, :] = tmlm.PAD_ID
    tokens[4, 2:] = tmlm.PAD_ID
    for mask_prob, p in ((0.15, 5), (0.5, 8), (1.0, 3)):
        want = jmlm.mask_batch(tokens, np.random.Generator(np.random.PCG64(7)),
                               vocab_size=60, max_predictions=p, mask_prob=mask_prob)
        got = tmlm.mask_batch(tokens, np.random.Generator(np.random.PCG64(7)),
                              vocab_size=60, max_predictions=p, mask_prob=mask_prob)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_mlm_batcher_over_the_loader_equals_jax(tmp_path):
    """``open_mlm_loader`` on the prepared shards (sequential), then
    ``MLMBatcher``'s masks for three batches, past the epoch's end."""
    paths = _write_corpus(tmp_path, lines=60)
    vocab = jtc.build_vocab(paths, max_size=30)
    directory = str(tmp_path / "mlm")
    jmlm.prepare_mlm_shards(paths, vocab, directory, seq_len=10, rows_per_shard=7,
                            segments=True)
    jloader, jmeta = jmlm.open_mlm_loader(directory, batch_size=6, shuffle=False)
    tloader, tmeta = tmlm.open_mlm_loader(directory, batch_size=6, shuffle=False)
    assert tmeta == jmeta
    jb = jmlm.MLMBatcher(jloader, vocab_size=jmeta["vocab_size"], max_predictions=4, seed=5)
    tb = tmlm.MLMBatcher(tloader, vocab_size=tmeta["vocab_size"], max_predictions=4, seed=5)
    try:
        for want, got in zip([jb.next() for _ in range(3)], [tb.next() for _ in range(3)]):
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    finally:
        jloader.close()
        tloader.close()
    with pytest.raises(FileNotFoundError):
        tmlm.open_mlm_loader(str(tmp_path), batch_size=2)


def _write_ratings(path, sep=",", header=True, seed=0):
    """Users with 18-30 distinct items each (so the filter drops some),
    raw ids not contiguous, timestamps out of order within a user."""
    rng = np.random.RandomState(seed)
    rows = []
    for u in range(12):
        n = rng.randint(18, 31)
        items = rng.choice(80, size=n, replace=False)
        stamps = rng.permutation(n) + 1000 * u
        rows += [(50 + 3 * u, 7 + 2 * int(i), int(rng.randint(1, 6)), int(t))
                 for i, t in zip(items, stamps)]
    with open(path, "w") as f:
        if header:
            f.write(sep.join(["user_id", "item_id", "rating", "timestamp"]) + "\n")
        for r in rows:
            f.write(sep.join(str(x) for x in r) + "\n")
    return path


@pytest.mark.parametrize("fmt", ["csv", "csv_no_header", "ml1m"])
def test_load_ratings_and_negatives_equal_jax(tmp_path, fmt):
    sep, header = {"csv": (",", True), "csv_no_header": (",", False),
                   "ml1m": ("::", False)}[fmt]
    path = _write_ratings(str(tmp_path / "ratings.dat"), sep=sep, header=header)
    jd, td = jml.load_ratings(path), tml.load_ratings(path)
    for field in ("num_users", "num_items", "train_users", "train_items", "eval_users",
                  "eval_items"):
        np.testing.assert_array_equal(getattr(td, field), getattr(jd, field), err_msg=field)
    assert td.num_train == jd.num_train and td.num_users < 12
    for key, value in jml.sample_training_epoch(jd, num_neg=3, seed=4).items():
        got = tml.sample_training_epoch(td, num_neg=3, seed=4)[key]
        assert got.dtype == value.dtype
        np.testing.assert_array_equal(got, value, err_msg=key)
    np.testing.assert_array_equal(tml.sample_eval_negatives(td, num_negatives=20, seed=2),
                                  jml.sample_eval_negatives(jd, num_negatives=20, seed=2))
    # Over the feasible pool: both clamp to the same count.
    np.testing.assert_array_equal(tml.sample_eval_negatives(td, seed=1),
                                  jml.sample_eval_negatives(jd, seed=1))


def test_training_shards_and_metrics_equal_jax(tmp_path):
    path = _write_ratings(str(tmp_path / "ratings.csv"), seed=1)
    jd, td = jml.load_ratings(path), tml.load_ratings(path)
    jml.write_training_shards(jd, str(tmp_path / "jax"), num_neg=2, rows_per_shard=100,
                              seed=3)
    tml.write_training_shards(td, str(tmp_path / "torch"), num_neg=2, rows_per_shard=100,
                              seed=3)
    _assert_same_shards(str(tmp_path / "jax"), str(tmp_path / "torch"),
                        ["users", "items", "labels"])
    # A fixed scorer with ties (item parity) and one that favours low ids.
    scorers = [lambda u, i: (i % 2).astype(np.float32),
               lambda u, i: -(i.astype(np.float32)) + 0.01 * u]
    for score_fn in scorers:
        for k, batch_users in ((10, None), (3, 4)):
            want = jml.hit_rate_and_ndcg(score_fn, jd, k=k, num_negatives=15, seed=6,
                                         batch_users=batch_users)
            got = tml.hit_rate_and_ndcg(score_fn, td, k=k, num_negatives=15, seed=6,
                                        batch_users=batch_users)
            assert got == want
    negatives = jml.sample_eval_negatives(jd, num_negatives=9)
    assert tml.hit_rate_and_ndcg(scorers[1], td, negatives=negatives) == \
        jml.hit_rate_and_ndcg(scorers[1], jd, negatives=negatives)


def _without_time(record):
    return {k: v for k, v in record.items() if k not in ("timestamp", "time_ms")}


def test_benchmark_logger_files_read_as_jax_s(tmp_path, monkeypatch):
    """The same calls through both loggers write the same lines (timestamps
    aside); the env var selects the file sink in both."""
    lines = {}
    for name, module in (("jax", jlogger), ("torch", tlogger)):
        directory = str(tmp_path / name)
        monkeypatch.setenv("AUTODIST_BENCHMARK_LOG_DIR", directory)
        logger = module.get_benchmark_logger()
        assert isinstance(logger, module.BenchmarkFileLogger)
        logger.log_run_info({"model_name": "bert", "batch_size": 8, "nested": {"a": [1, 2]}})
        logger.log_metric("examples_per_second", 123.5, unit="examples/s", global_step=10)
        logger.log_metric("dropped", "not a number")
        assert logger.log_metrics({"loss": 0.25, "lat": {"count": 3, "p50": 1.0}},
                                  global_step=11) == 2
        logger.on_finish(status="failure")
        lines[name] = {
            f: [json.loads(line) for line in
                open(os.path.join(directory, f)).read().splitlines()]
            for f in (tlogger.METRIC_LOG_FILE_NAME, tlogger.BENCHMARK_RUN_LOG_FILE_NAME)}
    assert lines["torch"][tlogger.BENCHMARK_RUN_LOG_FILE_NAME] == \
        lines["jax"][jlogger.BENCHMARK_RUN_LOG_FILE_NAME]
    metrics = {n: [_without_time(r) for r in lines[n][tlogger.METRIC_LOG_FILE_NAME]]
               for n in lines}
    assert metrics["torch"] == metrics["jax"]
    assert [r["name"] for r in metrics["torch"]] == ["examples_per_second", "loss", "lat",
                                                    "run_status"]
    assert metrics["torch"][-1]["value"] == 0.0
    monkeypatch.delenv("AUTODIST_BENCHMARK_LOG_DIR")
    assert type(tlogger.get_benchmark_logger()) is tlogger.BaseBenchmarkLogger


def test_run_info_and_mlperf_lines():
    info = tlogger.gather_run_info("ncf", strategy_name="Parallax", batch_size=64)
    want_keys = set(jlogger.gather_run_info("ncf")) - {"jax_version"}
    assert want_keys | {"torch_version", "cuda_version"} == set(info)
    assert info["machine_config"]["platform"] in ("gpu", "cpu")
    assert (info["strategy"], info["batch_size"]) == ("Parallax", 64)
    out_t, out_j = [], []
    tline = tlogger.mlperf_log("train_samples", 1024, out=out_t)
    jline = jlogger.mlperf_log("train_samples", 1024, out=out_j)
    assert out_t == [tline] and tline.startswith(":::MLL ")
    assert _without_time(json.loads(tline[7:])) == _without_time(json.loads(jline[7:]))


def test_data_package_exports_the_jax_names():
    """``from autodist_tpu_torch.data import X`` for every name the JAX
    package's data package exports."""
    import autodist_tpu_torch.data as tdata
    assert sorted(tdata.__all__) == sorted(jdata.__all__)
    for name in jdata.__all__:
        assert getattr(tdata, name) is not None, name
    from autodist_tpu_torch.data import DataLoader, device_prefetch  # noqa: F401
    assert tdata.mlm is tmlm and tdata.movielens is tml and tdata.text_corpus is ttc
