"""The port's train loop (autodist_tpu_torch.training.train), its device
feed (autodist_tpu_torch.data.prefetch) and throughput meter
(autodist_tpu_torch.utils.metrics), against the JAX package's, on the small
TransformerLM with the fused head; and the flagship entry point's host
smoke.

On the CPU every step is deterministic, so an interrupted and resumed run
must equal an uninterrupted one bit for bit, and the prefetching feed the
synchronous one. Against JAX ``train()``, everything f32: the losses rtol
1e-4 and the params atol 1e-5 after 3 Adam steps
(tests/test_torch_sequence_parallel.py's tolerances after Adam steps).
"""

import functools
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist, from_jax_params
from autodist_tpu_torch.data import prefetch
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.runner import BatchBlock
from autodist_tpu_torch.training import train
from autodist_tpu_torch.utils.metrics import ThroughputMeter

SMALL = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
ONE_GPU = {"nodes": [{"address": "localhost", "gpus": [0]}]}
BATCH, SEQ, ACCUM = 16, 16, 2


def _config(module, dtype):
    return module.TransformerLMConfig(**SMALL, dtype=dtype, tied_output=False,
                                      fused_head=True)


@functools.cache
def _jax_params():
    import jax
    from autodist_tpu.models import transformer_lm as jlm
    return jax.device_get(jlm.init_params(_config(jlm, np.float32), jax.random.PRNGKey(8))[1])


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return {"tokens": rng.randint(0, SMALL["vocab_size"],
                                  size=(BATCH, SEQ + 1)).astype(np.int32)}


def _runner():
    """A fresh port runner, with the losses of its steps recorded."""
    ad = AutoDist(resource_info=ONE_GPU, strategy_builder=AllReduce(), device="cpu")
    model = tlm.TransformerLM(_config(tlm, torch.float32))
    runner = ad.create_distributed_session(
        tlm.make_loss_fn(model), from_jax_params(_jax_params()),
        lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8), accumulation_steps=ACCUM)
    return _recording(runner)


def _recording(runner):
    runner.losses = []
    run = runner.run

    def recorded(state, batch, **kwargs):
        state, fetched = run(state, batch, **kwargs)
        runner.losses.append(float(fetched))
        return state, fetched

    runner.run = recorded
    return runner


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


@pytest.mark.parametrize("source", ["callable", "iterable"])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, source):
    """4 steps straight equal 2 steps, the final save, a fresh runner that
    resumes from it and 2 more steps: losses and params bit for bit. An
    iterable source is fast-forwarded past the 2 consumed batches."""
    def batches():
        return _batch if source == "callable" else (_batch(i) for i in range(100))

    straight = _runner()
    want = train(straight, from_jax_params(_jax_params()), batches(), steps=4, log_every=0)
    first, second = _runner(), _runner()
    ckpt = str(tmp_path / "ckpt")
    train(first, from_jax_params(_jax_params()), batches(), steps=2, checkpoint_dir=ckpt,
          log_every=0)
    got = train(second, from_jax_params(_jax_params()), batches(), steps=4,
                checkpoint_dir=ckpt, log_every=0)
    assert first.losses + second.losses == straight.losses
    assert got.step == want.step == 4
    for key, value in _params(want).items():
        assert torch.equal(got.params[key], value), key


def test_prefetch_feed_equals_synchronous_feed():
    """``prefetch_depth=2`` (two producer workers) gives the losses and
    params of the synchronous feed."""
    runs = []
    for depth in (0, 2):
        runner = _runner()
        state = train(runner, from_jax_params(_jax_params()), _batch, steps=4,
                      log_every=0, prefetch_depth=depth)
        runs.append((runner.losses, _params(state)))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        assert torch.equal(runs[1][1][key], value), key


def test_matches_jax_train_and_its_callbacks(tmp_path):
    """3 steps of JAX ``train()`` and the port's on the same data: the losses
    and params within the tolerances; ``on_metrics`` and ``on_eval`` fire at
    the same steps; periodic saves land at the same steps."""
    import jax
    import optax
    import autodist_tpu
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu.training import train as jtrain

    def hooks():
        seen = {"metrics": [], "eval": []}
        return seen, dict(log_every=1, eval_every=2, eval_batch=_batch(9), save_every=2,
                          on_metrics=lambda step, loss, rate: seen["metrics"].append(step),
                          on_eval=lambda step, value: seen["eval"].append((step, float(value))))

    jad = autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE_GPU), JAllReduce())
    jrunner = _recording(jad.create_distributed_session(
        jlm.make_loss_fn(jlm.TransformerLM(_config(jlm, np.float32))), _jax_params(),
        optax.adam(1e-3), accumulation_steps=ACCUM))
    jseen, jkw = hooks()
    jstate = jtrain(jrunner, _jax_params(), _batch, steps=3,
                    checkpoint_dir=str(tmp_path / "jax"), **jkw)
    runner = _runner()
    seen, kw = hooks()
    state = train(runner, from_jax_params(_jax_params()), _batch, steps=3,
                  checkpoint_dir=str(tmp_path / "port"), **kw)
    np.testing.assert_allclose(runner.losses, jrunner.losses, rtol=1e-4)
    want = from_jax_params(jax.device_get(jrunner.logical_params(jstate)))
    for key, value in want.items():
        np.testing.assert_allclose(state.params[key].detach().numpy(), value.numpy(),
                                   atol=1e-5, rtol=0, err_msg=key)
    assert seen["metrics"] == jseen["metrics"] == [2, 3]
    assert [s for s, _ in seen["eval"]] == [s for s, _ in jseen["eval"]] == [2]
    np.testing.assert_allclose(seen["eval"][0][1], jseen["eval"][0][1], rtol=1e-4)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_aux_and_fetches_match_jax():
    """``has_aux`` with 2-way accumulation (a per-example aux folds back to
    the batch's rows, a scalar averages over micro-batches) and
    ``fetches=`` (run on the pre-update params and the logical batch), one
    step against the JAX runner's."""
    import jax
    import jax.numpy as jnp
    import optax
    import autodist_tpu
    from autodist_tpu.models import transformer_lm as jlm
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy import AllReduce as JAllReduce

    jbase = jlm.make_loss_fn(jlm.TransformerLM(_config(jlm, np.float32)))
    tbase = tlm.make_loss_fn(tlm.TransformerLM(_config(tlm, torch.float32)))

    def jloss(params, batch):
        loss = jbase(params, batch)
        return loss, {"twice": 2 * loss, "first": batch["tokens"][:, 0].astype(jnp.float32)}

    def tloss(params, batch):
        loss = tbase(params, batch)
        return loss, {"twice": 2 * loss, "first": batch["tokens"][:, 0].float()}

    jstep = autodist_tpu.AutoDist(JResourceSpec(resource_info=ONE_GPU), JAllReduce()).function(
        jloss, _jax_params(), optax.adam(1e-3), has_aux=True, accumulation_steps=ACCUM)
    (jl, jaux), (jfirst, jsum) = jstep(_batch(0), fetches=lambda p, b: (
        b["tokens"][:, 0], jnp.sum(p["lm_head"]["kernel"] ** 2)))
    tstep = AutoDist(resource_info=ONE_GPU, strategy_builder=AllReduce(), device="cpu").function(
        tloss, from_jax_params(_jax_params()), lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
        has_aux=True, accumulation_steps=ACCUM)
    (tl, taux), (tfirst, tsum) = tstep(_batch(0), fetches=lambda p, b: (
        b["tokens"][:, 0], (p["lm_head.kernel"] ** 2).sum()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["twice"]), float(jaux["twice"]), rtol=1e-5)
    assert taux["first"].shape == (BATCH,)
    np.testing.assert_array_equal(taux["first"].numpy(), np.asarray(jaux["first"]))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_allclose(float(tsum), float(jsum), rtol=1e-5)
    np.testing.assert_allclose(float(tsum), float((_jax_params()["lm_head"]["kernel"] ** 2).sum()),
                               rtol=1e-5)
    assert not taux["twice"].requires_grad


def test_unported_parts_raise(monkeypatch, tmp_path):
    """What was refused before the telemetry planes were ported now runs:
    ``health_monitor=`` (the monitor sees every step's loss and the bundle),
    and ``AUTODIST_HEALTH`` (a monitor from the environment and a runner
    that computes the bundle), ``AUTODIST_PROFILE`` (a profile under
    ``AUTODIST_PROFILE_DIR``), ``AUTODIST_METRICS_PORT`` (a scrape endpoint
    on a free loopback port) and ``AUTODIST_ALERT_ACTION``; each leaves the
    params equal to a plain run's. unroll > 1 runs as well."""
    from autodist_tpu_torch import telemetry
    from autodist_tpu_torch.telemetry import openmetrics, profiling
    params = from_jax_params(_jax_params())
    plain = train(_runner(), params, _batch, steps=2, log_every=1)
    monitor = telemetry.HealthMonitor(telemetry.HealthConfig(action="warn"))
    runner = _runner()
    runner.health = True
    state = train(runner, params, _batch, steps=2, log_every=1, health_monitor=monitor)
    assert monitor.anomalies == [] and runner.last_health.shape == (4,)
    assert torch.equal(state.params["lm_head.kernel"], plain.params["lm_head.kernel"])
    was = telemetry.enabled()
    # The scrape endpoint binds loopback on a free port; the flag names it.
    exporter = openmetrics.MetricsExporter(port=0, host="127.0.0.1")
    openmetrics.set_exporter(exporter)
    try:
        for flag, value in (("AUTODIST_HEALTH", "1"), ("AUTODIST_PROFILE", "1"),
                            ("AUTODIST_METRICS_PORT", str(exporter.address[1])),
                            ("AUTODIST_ALERT_ACTION", "warn")):
            with monkeypatch.context() as m:
                m.setenv(flag, value)
                m.setenv("AUTODIST_PROFILE_DIR", str(tmp_path / flag))
                if flag == "AUTODIST_PROFILE":
                    profiling.enable()
                try:
                    runner = _runner()
                    state = train(runner, params, _batch, steps=2, log_every=1)
                finally:
                    profiling.disable()
                    profiling.reset()
                    if not was:
                        telemetry.disable()
                assert torch.equal(state.params["lm_head.kernel"],
                                   plain.params["lm_head.kernel"])
                if flag == "AUTODIST_HEALTH":
                    assert runner.health and runner.last_health is not None
                if flag == "AUTODIST_PROFILE":
                    assert os.listdir(tmp_path / flag)
                if flag == "AUTODIST_METRICS_PORT":
                    url = "http://127.0.0.1:%d/metrics" % exporter.address[1]
                    with urllib.request.urlopen(url, timeout=10) as r:
                        assert b"train_steps_per_s" in r.read()
    finally:
        openmetrics.set_exporter(None)
    assert train(_runner(), params, _batch, steps=2, unroll=2).step == 2
    with prefetch.prefetch_to_device([_batch(0), _batch(1)], _runner(), unroll=2) as feed:
        block = next(feed)
    assert isinstance(block, BatchBlock) and len(block) == 2


# ------------------------------------------------------------- the feed core

def test_producer_order_errors_exhaustion_and_close():
    """Emission keeps the pull order across 3 workers whose transforms
    finish out of order; a source exception re-raises at its position;
    exhaustion ends iteration; a closed producer raises QueueClosed."""
    def slow_square(x):
        time.sleep(0.02 * ((7 * x) % 3))
        return x * x

    with prefetch.PrefetchProducer(iter(range(12)).__next__, slow_square, depth=3,
                                   workers=3) as feed:
        assert list(feed) == [x * x for x in range(12)]

    def failing():
        for i in range(5):
            if i == 3:
                raise ValueError("bad batch 3")
            yield i

    feed = prefetch.PrefetchProducer(failing().__next__, depth=2, workers=2)
    assert [next(feed) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bad batch 3"):
        next(feed)
    with pytest.raises(StopIteration):
        next(feed)
    feed.close()

    blocked = prefetch.PrefetchProducer(iter(range(1000)).__next__, depth=1)
    t0 = time.monotonic()
    blocked.close()
    assert time.monotonic() - t0 < 5
    with pytest.raises(prefetch.QueueClosed):
        next(blocked)
    assert not any(t.name.startswith("prefetch-") and t.is_alive()
                   for t in threading.enumerate())


def test_bounded_queue_and_host_rows():
    q = prefetch.BoundedQueue(1)
    assert q.try_put("a") and not q.try_put("b")
    assert q.get(timeout_s=0.1) == "a" and q.get(timeout_s=0.05) is prefetch.EMPTY
    q.try_put("c")
    assert q.close() == ["c"]
    with pytest.raises(prefetch.QueueClosed):
        q.try_put("d")
    with pytest.raises(prefetch.QueueClosed):
        q.get()
    assert [prefetch.host_shard_rows(12, p, 3) for p in range(3)] == [(0, 4), (4, 8), (8, 12)]
    batch = {"tokens": np.arange(24).reshape(12, 2), "table": np.zeros((5, 2))}
    part = prefetch.host_shard(batch, process_id=1, num_processes=3, batch_rows=12)
    assert part["tokens"].tolist() == batch["tokens"][4:8].tolist()
    assert part["table"].shape == (5, 2)


def test_prefetch_to_device_and_meter():
    """The feed lays batches out as the runner does (micro-batched); the
    meter excludes its warm-up step and rates each period."""
    runner = _runner()
    with prefetch.prefetch_to_device([_batch(0), _batch(1)], runner, depth=2) as feed:
        got = list(feed)
    assert len(got) == 2 and got[0]["tokens"].value.shape == (ACCUM, BATCH // ACCUM, SEQ + 1)
    meter = ThroughputMeter(batch_size=8, log_every=2)
    rates = [meter.step(sync=torch.tensor(1.0)) for _ in range(5)]
    assert rates[:2] == [None, None] and rates[2] > 0 and rates[3] is None and rates[4] > 0
    assert meter.finish() > 0 and len(meter.history) == 2


def test_flagship_entry_point_host_smoke(capsys):
    """``python -m autodist_tpu_torch.examples.flagship_lm`` at a tiny size
    on the host prints one JSON line with bench.py's keys and no device
    metric; its defaults are the flagship's shape."""
    from autodist_tpu_torch.examples import flagship_lm

    result = flagship_lm.main(["--device", "cpu", "--micro_batch", "2", "--seq_len", "16",
                               "--accum", "2", "--d_model", "32", "--n_layers", "1",
                               "--vocab", "64", "--steps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert {"metric", "value", "unit", "flops_per_token", "mfu",
            "max_memory_allocated"} <= set(line)
    assert line["unit"] == "tokens/s" and line["value"] > 0
    assert line["mfu"] is None and line["max_memory_allocated"] is None
    assert "cpu x1, d32x1, seq16, bs4=2x2accum" in line["metric"]
    args = flagship_lm.parse_args([])
    assert (args.micro_batch, args.seq_len, args.accum, args.steps, args.d_model,
            args.n_layers, args.vocab) == (384, 256, 8, 20, 512, 6, 32_000)
