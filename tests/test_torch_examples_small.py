"""The port's four self-contained examples (autodist_tpu_torch.examples:
linear_regression, multiprocess_linear_regression, sentiment_classifier,
image_classifier) at a few steps on the host.

Where an example's weights and batches come from numpy seeds (linear
regression, the sentiment classifier), its losses are held against the JAX
example's own run (rtol 1e-5 for full-batch SGD; 1e-4 for Adam, whose
normalised update amplifies the two frameworks' summation orders, as in
tests/test_torch_autodist.py). The image classifier's weights come from each
package's own initializer, so it is held to training: its loss falls. The
two-process examples run over 2 gloo ranks in one spawn (the environment
torchrun sets): the multi-process linear regression against a hand-computed
single-process run (rtol 1e-6, as tests/test_multiprocess.py holds the JAX
one), and the sentiment classifier, whose table's gradient then crosses the
ranks as (indices, rows), against its one-process run (rtol 1e-4).

The benchmark suite's entry points (autodist_tpu_torch.examples.benchmark:
bert, ncf, disk_input, raw_torch_baseline, run_all, and imagenet's run-info
files) run a couple of steps each at tiny sizes on the host: their modes
run end to end and report finite numbers, each rate line parses as
``run_all`` parses it, and ``run_all`` lists the JAX sweep's rows with the
one it cannot run yet marked "not ported". The parallelism entry points
``moe_lm`` (one process) and ``pipeline_lm`` (the 2 gloo ranks of the
spawn, a pipe of 2) train tiny models: the pipeline's losses equal the
same steps replayed in one process (rtol 1e-4, Adam).
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from autodist_tpu_torch.examples import (image_classifier, linear_regression, moe_lm,
                                         multiprocess_linear_regression, pipeline_lm,
                                         sentiment_classifier)
from autodist_tpu_torch.examples.benchmark import bert as bert_bench
from autodist_tpu_torch.examples.benchmark import (disk_input, ncf, raw_torch_baseline,
                                                   run_all)
from test_torch_ring_attention import join_gloo_group, ranks_running

SENTIMENT_STEPS = 10
PIPELINE_TINY = ["--device", "cpu", "--n_stages", "2", "--batch_size", "4", "--seq_len", "16",
                 "--d_model", "32", "--n_layers", "2", "--microbatches", "2", "--vocab",
                 "128", "--steps", "2"]


def _two_rank_worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    multiprocess_linear_regression.main(str(workdir / "mp_lr.json"), device="cpu")
    losses = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.save(workdir / f"sentiment_rank{dist.get_rank()}.npy", np.array(losses))
    result = bert_bench.main(BERT_TINY + BERT_DP)
    np.save(workdir / f"bert_rank{dist.get_rank()}.npy", np.array([result["final_loss"]]))
    result = pipeline_lm.main(PIPELINE_TINY)
    np.save(workdir / f"pipeline_rank{dist.get_rank()}.npy", np.array([result["final_loss"]]))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("examples")
    with ranks_running(pathlib.Path(__file__), 2, "examples", workdir) as wait:

        @functools.cache
        def results():
            logs = wait()
            return workdir, logs

        yield results


def test_linear_regression_tracks_the_jax_example():
    import examples.linear_regression as jexample
    np.testing.assert_allclose(linear_regression.main(device="cpu"), jexample.main(),
                               rtol=1e-5)


def test_sentiment_routes_the_table_to_ps_and_tracks_the_jax_example():
    """The routing assertion holds inside ``main``; the losses follow JAX's."""
    import examples.sentiment_classifier as jexample
    got = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.testing.assert_allclose(got, jexample.main(steps=SENTIMENT_STEPS), rtol=1e-4)


def test_image_classifier_trains_from_the_native_loader(capsys):
    losses = image_classifier.main(epochs=2, device="cpu")
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert "loader=native" in capsys.readouterr().out


def _hand_sgd():
    w = b = np.float32(0.0)
    losses = []
    for step in range(multiprocess_linear_regression.STEPS):
        batch = multiprocess_linear_regression.make_batch(step)
        err = batch["y"] - (batch["x"] * w + b)
        losses.append(float(np.mean(err ** 2)))
        dw = np.mean(-2.0 * batch["x"] * err, dtype=np.float32)
        db = np.mean(-2.0 * err, dtype=np.float32)
        w, b = w - np.float32(multiprocess_linear_regression.LR) * dw, \
            b - np.float32(multiprocess_linear_regression.LR) * db
    return float(w), float(b), losses


def test_two_rank_linear_regression_matches_a_hand_computed_run(two_ranks):
    workdir, _ = two_ranks()
    result = json.loads((workdir / "mp_lr.json").read_text())
    assert result["process_count"] == 2 and result["device_count"] == 2
    w, b, losses = _hand_sgd()
    np.testing.assert_allclose([result["w"], result["b"]], [w, b], rtol=1e-6)
    np.testing.assert_allclose(result["losses"], losses, rtol=1e-6)


def test_two_rank_sentiment_sends_the_sparse_wire(two_ranks):
    """Both ranks route the table to PS (asserted in ``main``) and report
    the global loss, which follows the one-process run."""
    workdir, logs = two_ranks()
    ranks = [np.load(workdir / f"sentiment_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    single = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.testing.assert_allclose(ranks[0], single, rtol=1e-4)
    assert all("'embedding': 'ps_synchronizer'" in log for log in logs)


BERT_TINY = ["--device", "cpu", "--size", "tiny", "--seq_len", "16", "--max_predictions", "4"]
# One step of 8 sequences in 2 micro-batches: the loss before any update.
BERT_DP = ["--batch_size", "8", "--accum", "2", "--steps", "1"]


@pytest.mark.parametrize("accum", [1, 2])
def test_bert_benchmark_trains_synthetic(capsys, accum):
    result = bert_bench.main(BERT_TINY + ["--batch_size", "4", "--steps", "3",
                                          "--log_every", "1", "--accum", str(accum)])
    assert np.isfinite(result["final_loss"]) and result["examples_per_sec"] > 0
    assert result["mfu"] is None and result["source"] == "synthetic"
    row = run_all.parse_output("bert_base", capsys.readouterr().out)
    assert row["rate"] == pytest.approx(result["examples_per_sec"], abs=0.05)


def test_two_rank_bert_benchmark_reports_the_global_loss(two_ranks):
    """Over 2 data ranks (each 2 of every micro-batch's 4 rows) the BERT
    benchmark's first loss is the one-process run's."""
    workdir, _ = two_ranks()
    ranks = [np.load(workdir / f"bert_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    single = bert_bench.main(BERT_TINY + BERT_DP)
    np.testing.assert_allclose(ranks[0][0], single["final_loss"], rtol=1e-5)


def test_bert_benchmark_tokenizes_trains_saves_and_evaluates(tmp_path):
    """``--tokenize_corpus`` writes the MLM shards, ``--data_dir`` trains
    from them with dynamic masks through the device feed, and ``--eval
    --restore`` scores a pass with the saved weights."""
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.data import mlm

    rng = np.random.RandomState(0)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(" ".join(f"w{i}" for i in rng.zipf(1.3, size=20) % 50)
                                for _ in range(40)))
    data = str(tmp_path / "mlm")
    assert bert_bench.main(["--tokenize_corpus", str(corpus), "--data_dir", data,
                            "--seq_len", "16"]) == 0
    assert mlm.read_meta(data)["seq_len"] == 16
    args = bert_bench.parse_args(BERT_TINY + ["--data_dir", data, "--batch_size", "4",
                                              "--steps", "3"])
    bench = bert_bench.build(args)
    try:
        result = bert_bench.train(bench)
        prefix = Saver().save(bench.step.get_state(), str(tmp_path / "ckpt" / "bert"))
    finally:
        bench.close()
    assert result["source"] == "disk" and np.isfinite(result["final_loss"])
    acc = bert_bench.main(BERT_TINY + ["--data_dir", data, "--batch_size", "4", "--eval",
                                       "--restore", prefix])
    assert 0.0 <= acc <= 1.0
    with pytest.raises(ValueError, match="seq_len"):
        bert_bench.build(bert_bench.parse_args(["--device", "cpu", "--data_dir", data,
                                                "--seq_len", "32"]))


def _write_ratings(path, users=30, per_user=22, items=60, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        f.write("user_id,item_id,rating,timestamp\n")
        for u in range(users):
            for t, i in enumerate(rng.choice(items, per_user, replace=False)):
                f.write(f"{u},{i},{rng.randint(1, 6)},{t}\n")
    return path


def test_ncf_benchmark_routes_tables_to_ps_and_reports_hr(tmp_path, capsys):
    from autodist_tpu_torch.parallel.plan import SYNC_PS
    args = ncf.parse_args(["--device", "cpu", "--batch_size", "256", "--steps", "2",
                           "--log_every", "1"])
    bench = ncf.build(args)
    try:
        plans = bench.step.runner.plan.params
        tables = sorted(n for n in plans if n.endswith("_embed/embedding"))
        assert len(tables) == 4 and all(plans[n].sync == SYNC_PS for n in tables)
        assert all(plans[n].sync != SYNC_PS for n in plans if n not in tables)
        result = ncf.train(bench)
    finally:
        bench.close()
    assert np.isfinite(result["final_loss"])
    assert run_all.parse_output("ncf", capsys.readouterr().out)["rate"] > 0
    result = ncf.main(["--device", "cpu", "--ratings", _write_ratings(str(tmp_path / "r.csv")),
                       "--batch_size", "512", "--steps", "3"])
    assert result["source"] == "ratings" and 0.0 <= result["ndcg"] <= result["hr"] <= 1.0


def test_ncf_parallax_equals_allreduce_on_one_device():
    """On one device ``Parallax``'s PS route reduces nothing, so its three
    steps give ``AllReduce()``'s losses and params bit for bit (the chip
    smoke holds the same at the real batch)."""
    from autodist_tpu_torch.models import ncf as tncf
    batches = [tncf.synthetic_batch(tncf.NeuMFConfig(), 128, seed=10 + i) for i in range(3)]
    runs = []
    for strategy in ("Parallax", "AllReduce"):
        b = ncf.build(ncf.parse_args(["--device", "cpu", "--batch_size", "128",
                                      "--strategy", strategy]))
        losses = [float(b.step(batch)) for batch in batches]
        runs.append((losses, b.step.runner.logical_params(b.step.get_state())))
    (pl, pp), (al, ap) = runs
    assert pl == al and all(torch.equal(pp[k], ap[k]) for k in pp)


def test_disk_input_streams_through_the_native_loader():
    result = disk_input.main(["--device", "cpu", "--rows", "48", "--steps", "1"])
    assert result["native_loader"] and result["corpus_rows"] == 48 and result["shards"] == 8
    assert result["resident_tokens_per_sec"] > 0 and result["disk_tokens_per_sec"] > 0


def test_raw_torch_baseline_trains_on_the_host(capsys):
    result = raw_torch_baseline.main(["--device", "cpu", "--model", "resnet50", "--stages",
                                      "1", "--image_size", "24", "--batch_size", "2",
                                      "--steps", "1"])
    assert np.isfinite(result["final_loss"]) and result["mfu"] is None
    assert "raw-torch resnet50 bs2" in capsys.readouterr().out


def test_run_all_lists_the_jax_rows_and_refuses_unported(capsys):
    import examples.benchmark.run_all as jrun_all
    assert run_all.main(["--list"]) == []
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(jrun_all.CONFIGS)
    assert {line.split()[0]: line.split(None, 1)[1] for line in lines if " " in line} == {
        "lm1b_lstm": "not ported (ROADMAP Queue 1 item 5)"}
    for argv in (["--only", "lm1b_lstm"], ["--only", "ncf,lm1b_lstm"], ["--update_baseline"]):
        with pytest.raises(SystemExit) as exc:
            run_all.main(argv)
        assert exc.value.code != 0
    flagship = run_all.parse_output("flagship", '{"value": 604406.3, "mfu": 0.1351}')
    assert (flagship["rate"], flagship["mfu_pct"]) == (604406.3, 13.51)
    assert run_all.parse_output("ncf", "nothing")["rate"] is None
    moe = run_all.parse_output("moe", "moe: final loss 9.5; average 123,456.7 tokens/sec "
                                      "(mesh={'data': 1})\nmfu 12.34% (1.0 TFLOP/s, 2 GFLOP/step)")
    assert (moe["rate"], moe["mfu_pct"]) == (123456.7, 12.34)


def test_moe_lm_trains_on_the_host(capsys):
    """The MoE entry point at a tiny size with accumulation: a finite loss,
    the JAX example's result line (as ``run_all``'s moe row parses it), and
    no MFU on the host."""
    result = moe_lm.main(["--device", "cpu", "--batch_size", "4", "--accum", "2", "--seq_len",
                          "16", "--d_model", "32", "--n_layers", "1", "--vocab", "128",
                          "--steps", "3", "--log_every", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(result["final_loss"]) and result["mfu"] is None
    assert result["mesh"] == {"data": 1} and "mfu not measured" in out
    assert run_all.parse_output("moe", out)["rate"] == pytest.approx(
        result["tokens_per_sec"], abs=0.05)


def test_two_rank_pipeline_lm_equals_its_replay(two_ranks):
    """``pipeline_lm`` under torchrun over 2 gloo ranks (a pipe of 2, GPipe):
    both ranks report the loss of the same two Adam steps replayed in one
    process."""
    from autodist_tpu_torch.models import pipeline_lm as plm
    from autodist_tpu_torch.parallel.mesh import replay_mesh
    workdir, logs = two_ranks()
    ranks = [np.load(workdir / f"pipeline_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    assert "pipeline: final loss" in logs[0] and "mesh={'pipe': 2}" in logs[0]
    args = pipeline_lm.parse_args(PIPELINE_TINY)
    cfg = plm.PipelineLMConfig(vocab_size=128, d_model=32, n_heads=8, n_layers=2, d_ff=128,
                               max_len=17, n_stages=2, num_microbatches=2, dtype=torch.float32)
    model, params = plm.init_params(cfg, seed=0, device="cpu")
    params = {k: v.requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3, eps=1e-8)
    batch = {"tokens": torch.tensor(plm.synthetic_batch(cfg, args.batch_size, args.seq_len)[
        "tokens"])}
    with replay_mesh({"pipe": 2}):
        for _ in range(args.steps):
            opt.zero_grad()
            loss = plm.make_loss_fn(model)(params, batch)
            loss.backward()
            opt.step()
    np.testing.assert_allclose(ranks[0][0], float(loss.detach()), rtol=1e-4)


def test_imagenet_benchmark_writes_run_info(tmp_path, monkeypatch):
    """The benchmark logger's files: the run info and the rates, then
    run_status 1; a step whose batch raises records run_status 0 (failure)."""
    from autodist_tpu_torch.examples.benchmark import imagenet as bench
    monkeypatch.setenv("AUTODIST_BENCHMARK_LOG_DIR", str(tmp_path / "logs"))
    argv = ["--device", "cpu", "--stages", "1", "--image_size", "24", "--batch_size", "4",
            "--steps", "2", "--log_every", "1"]
    bench.main(argv)
    info = json.loads((tmp_path / "logs" / "benchmark_run.log").read_text())
    assert (info["model_name"], info["strategy"], info["batch_size"]) == \
        ("resnet50", "AllReduce", 4)
    metrics = [json.loads(line) for line in
               (tmp_path / "logs" / "metric.log").read_text().splitlines()]
    assert [m["name"] for m in metrics] == ["examples_per_second", "average_examples_per_second",
                                            "run_status"]
    assert metrics[-1]["value"] == 1.0 and metrics[0]["global_step"] == 2

    b = bench.build(bench.parse_args(argv))

    def broken():
        raise RuntimeError("step failed")

    b.next_batch = broken
    with pytest.raises(RuntimeError, match="step failed"):
        bench.train(b)
    last = json.loads((tmp_path / "logs" / "metric.log").read_text().splitlines()[-1])
    assert (last["name"], last["value"], last["extras"]) == \
        ("run_status", 0.0, {"status": "failure"})


if __name__ == "__main__":
    if sys.argv[1] == "examples":
        _two_rank_worker(pathlib.Path(sys.argv[2]))
