"""The port's serving plane (autodist_tpu_torch.serving): the batcher, the
dense LM engine, the apply engine, the wire and the SLO metrics, on the CPU.

The batcher units are tests/test_batched_serving.py's, over the same fake
engine and driven by ``run_once()`` (a deadline is moved, never slept on).
The engine legs hold served tokens against the port's ``generate``, which
tests/test_torch_generate.py holds against the JAX package's; the wire leg
runs a JAX ``ServeClient`` against the port's ``InferenceServer`` and the
port's client against a JAX server, with one set of weights (f32): the
greedy tokens must be equal. Sampled tokens are held against the port's own
``generate`` with the same seed (no parity with ``jax.random``). Every wait
on a thread or a socket has its own bound.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch import serving, telemetry, to_jax_params
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.serving import (Batcher, LMEngine, ServeConfig, ServeError,
                                        bucket_for, default_buckets, pad_prompt)

SMALL = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=32)
JOIN_S = 60.0


# ------------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def lm():
    model, params = tlm.init_params(tlm.TransformerLMConfig(**SMALL, dtype=torch.float32),
                                    seed=3, device="cpu")
    return model, params


@pytest.fixture(scope="module")
def greedy_engine(lm):
    """One shared greedy engine (capacity 2); tests free every slot they use."""
    model, params = lm
    return LMEngine(model, params, ServeConfig(max_batch=2))


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 97, size=n).astype(np.int32)


def _drive(batcher, reqs, rounds=80):
    for _ in range(rounds):
        if all(r.done.is_set() for r in reqs):
            break
        batcher.run_once()
    assert all(r.done.is_set() for r in reqs), "batcher did not converge"


def _generate(lm, prompt, n, **kw):
    model, params = lm
    return tlm.generate(model, params, torch.tensor(prompt[None]), n, **kw).numpy()[0]


# ------------------------------------------------- bucketing / packing units

def test_default_buckets_power_of_two_with_max_cap():
    assert default_buckets(32) == (8, 16, 32)
    assert default_buckets(48) == (8, 16, 32, 48)
    assert default_buckets(8) == (8,)


def test_bucket_for_picks_smallest_fit_and_rejects_oversize():
    assert bucket_for(3, (8, 16)) == 8
    assert bucket_for(8, (8, 16)) == 8
    assert bucket_for(9, (8, 16)) == 16
    with pytest.raises(ServeError):
        bucket_for(17, (8, 16))


def test_pad_prompt_right_pads_to_bucket():
    out = pad_prompt(np.array([5, 6, 7], np.int32), 8)
    assert out.shape == (1, 8) and out.dtype == np.int32
    assert list(out[0]) == [5, 6, 7, 0, 0, 0, 0, 0]


def test_serve_config_validates_and_reads_env(monkeypatch):
    with pytest.raises(ValueError):
        ServeConfig(mode="adaptive")
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError):
        ServeConfig(buckets=(16, 8))
    monkeypatch.setenv("AUTODIST_SERVE_MAX_BATCH", "5")
    monkeypatch.setenv("AUTODIST_SERVE_MODE", "static")
    cfg = ServeConfig.from_env(max_queue=7)
    assert cfg.max_batch == 5 and cfg.mode == "static" and cfg.max_queue == 7
    monkeypatch.delenv("AUTODIST_SERVE_MAX_BATCH")
    monkeypatch.delenv("AUTODIST_SERVE_MODE")
    cfg = ServeConfig.from_env()
    assert (cfg.max_batch, cfg.mode, cfg.max_queue, cfg.request_timeout_s) == \
        (8, "continuous", 256, 120.0)


def test_transport_env_address_default(monkeypatch):
    from autodist_tpu_torch.serving import transport
    monkeypatch.delenv("AUTODIST_SERVE_ADDR", raising=False)
    assert transport._env_address() == ("127.0.0.1", 0)
    monkeypatch.setenv("AUTODIST_SERVE_ADDR", "10.0.0.5:7701")
    assert transport._env_address() == ("10.0.0.5", 7701)


# --------------------------------------------- fake-engine batcher semantics

class FakeEngine:
    """Deterministic model-free engine: token = 100*slot + step index."""

    def __init__(self, capacity=2, max_len=32):
        self.capacity = capacity
        self.max_len = max_len
        self.buckets = default_buckets(max_len)
        self.admits = []
        self.freed = []
        self._steps = np.zeros(capacity, np.int64)

    def make_keys(self, seed, n):
        return None

    def admit(self, slot, prompt, key):
        self.admits.append((slot, int(prompt.size)))
        self._steps[slot] = 0
        return 100 * slot

    def step(self, keys):
        self._steps += 1
        return (100 * np.arange(self.capacity) + self._steps).astype(np.int32)

    def free(self, slot):
        self.freed.append(slot)


def test_continuous_early_exit_frees_slot_for_waiter():
    eng = FakeEngine(capacity=2)
    b = Batcher(eng, ServeConfig(max_batch=2), start=False)
    r_long = b.submit(_prompt(4), 8)
    r_short = b.submit(_prompt(3), 2)
    r_wait = b.submit(_prompt(5), 2)
    b.run_once()
    assert [s for s, _ in eng.admits] == [0, 1]
    assert b.queue_depth() == 1
    b.run_once()
    assert r_short.done.is_set() and not r_long.done.is_set()
    assert eng.admits[2][0] == eng.freed[0]
    _drive(b, [r_long, r_wait])
    assert not r_long.error and not r_wait.error
    assert r_short.tokens[0] == 100 * r_short.slot
    assert len(r_long.tokens) == 8 and len(r_wait.tokens) == 2


def test_static_mode_admits_only_full_waves():
    eng = FakeEngine(capacity=2)
    b = Batcher(eng, ServeConfig(max_batch=2, mode="static"), start=False)
    reqs = [b.submit(_prompt(3), n) for n in (2, 4, 2)]
    b.run_once()
    assert len(eng.admits) == 2
    b.run_once()
    assert len(eng.admits) == 2
    _drive(b, reqs)
    assert len(eng.admits) == 3


def test_queue_full_rejects_instantly():
    b = Batcher(FakeEngine(capacity=1), ServeConfig(max_batch=1, max_queue=1), start=False)
    b.submit(_prompt(3), 2)
    with pytest.raises(serving.ServeBusy, match="queue is full"):
        b.submit(_prompt(3), 2)


def test_submit_validation_rejects_malformed_requests():
    b = Batcher(FakeEngine(capacity=1, max_len=32), ServeConfig(max_batch=1), start=False)
    with pytest.raises(ServeError, match="1-D integer"):
        b.submit(np.zeros((2, 3), np.int32), 2)
    with pytest.raises(ServeError, match="1-D integer"):
        b.submit(np.zeros(3, np.float32), 2)
    with pytest.raises(ServeError, match="positive int"):
        b.submit(_prompt(3), 0)
    with pytest.raises(ServeError, match="exceeds"):
        b.submit(_prompt(3), 64)
    with pytest.raises(ServeError, match="pad bucket"):
        b.submit(_prompt(33), 1)


def test_eos_stops_generation_early():
    class EosEngine(FakeEngine):
        def step(self, keys):
            toks = super().step(keys)
            return np.where(self._steps == 2, 7, toks).astype(np.int32)

    b = Batcher(EosEngine(capacity=1), ServeConfig(max_batch=1, eos_id=7), start=False)
    req = b.submit(_prompt(3), 10)
    _drive(b, [req])
    assert req.tokens[-1] == 7 and len(req.tokens) == 3


def test_close_fails_pending_and_later_requests():
    b = Batcher(FakeEngine(capacity=1), ServeConfig(max_batch=1), start=False)
    req = b.submit(_prompt(3), 4)
    b.close()
    assert req.done.is_set() and "shutting down" in req.error
    with pytest.raises(ServeError, match="shutting down"):
        b.submit(_prompt(3), 2)


def test_abandoned_queued_request_never_reaches_the_engine():
    eng = FakeEngine(capacity=1)
    b = Batcher(eng, ServeConfig(max_batch=1), start=False)
    r_active = b.submit(_prompt(3), 3)
    r_dead = b.submit(_prompt(4), 3)
    r_live = b.submit(_prompt(5), 2)
    r_dead.abandon()
    _drive(b, [r_active, r_dead, r_live])
    assert "abandoned" in r_dead.error and not r_dead.tokens
    assert r_live.error is None and len(r_live.tokens) == 2
    assert [n for _, n in eng.admits] == [3, 5]


def test_abandoned_inflight_request_frees_its_slot_early():
    eng = FakeEngine(capacity=1)
    b = Batcher(eng, ServeConfig(max_batch=1), start=False)
    r_dead = b.submit(_prompt(3), 20)
    r_live = b.submit(_prompt(4), 2)
    b.run_once()
    assert r_dead.slot == 0 and not r_dead.done.is_set()
    r_dead.abandon()
    b.run_once()
    assert r_dead.done.is_set() and "abandoned" in r_dead.error
    assert len(r_dead.tokens) < 20
    _drive(b, [r_live])
    assert r_live.error is None and eng.freed[0] == 0


def test_expired_requests_are_dropped_queued_and_in_flight():
    """A deadline that passes in the queue drops the request at the pop; one
    that passes mid-generation frees the slot at the next round."""
    eng = FakeEngine(capacity=1)
    b = Batcher(eng, ServeConfig(max_batch=1), start=False)
    req = b.submit(_prompt(3), 20)
    b.run_once()
    assert req.slot == 0 and not req.done.is_set()
    queued = b.submit(_prompt(4), 2)
    req.deadline = queued.deadline = req.t_submit - 1.0    # both past now
    b.run_once()
    assert req.done.is_set() and "timed out" in req.error
    assert len(req.tokens) < 20 and eng.freed == [0]
    b.run_once()                  # the freed slot's next admission pops the waiter
    assert queued.done.is_set() and "timed out" in queued.error
    assert len(eng.admits) == 1


# ----------------------------------------------------- LM engine parity legs

@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_k": 5}])
def test_batch1_served_equals_generate(lm, greedy_engine, sampling):
    """A request served alone equals the port's ``generate`` with its seed,
    token for token: padded prefill, per-row decode positions and the
    shared key schedule included."""
    engine = greedy_engine if not sampling else LMEngine(
        *lm, ServeConfig(max_batch=2, **sampling))
    b = Batcher(engine, engine.config, start=False)
    prompt = _prompt(7, seed=1)
    req = b.submit(prompt, 8, seed=3)
    _drive(b, [req])
    assert req.error is None
    np.testing.assert_array_equal(_generate(lm, prompt, 8, rng=3, **sampling),
                                  np.asarray(req.tokens, np.int32))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_concurrent_slots_match_batch1_references(lm, temperature):
    """Requests of different lengths and budgets through a 2-slot batch,
    with early exits reusing slots (no scrub): every stream equals its own
    batch-1 run, greedy and sampled (a slot's draws do not depend on its
    batch mates). The step shapes stay within the bucket bound."""
    engine = LMEngine(*lm, ServeConfig(max_batch=2, temperature=temperature))
    b = Batcher(engine, engine.config, start=False)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 97, size=n).astype(np.int32) for n in (3, 11, 6, 20)]
    news = [9, 4, 7, 3]
    reqs = [b.submit(p, n, seed=i) for i, (p, n) in enumerate(zip(prompts, news))]
    _drive(b, reqs)
    for i, (p, n, req) in enumerate(zip(prompts, news, reqs)):
        assert req.error is None
        np.testing.assert_array_equal(_generate(lm, p, n, rng=i, temperature=temperature),
                                      np.asarray(req.tokens, np.int32))
    n_prefill, n_total = engine.compiled_programs()
    assert n_prefill <= len(engine.buckets) and n_total <= len(engine.buckets) + 2


def test_scheduler_thread_records_no_autograd(lm):
    """Grad mode is per thread: the batcher's own thread must not build a
    graph over params that require grad."""
    model, params = lm
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    engine = LMEngine(model, live, ServeConfig(max_batch=1))
    b = Batcher(engine, engine.config)
    try:
        req = b.submit(_prompt(5, seed=2), 3)
        assert req.done.wait(JOIN_S) and req.error is None
        assert all(not t.requires_grad for t in engine._cache.values())
    finally:
        b.close()


def test_apply_engine_parity_and_padding():
    rng = np.random.RandomState(0)
    params = {"w": torch.tensor(rng.randn(5, 3).astype(np.float32))}

    def apply_fn(params, x):
        return x @ params["w"]

    eng = serving.ApplyEngine(apply_fn, params, ServeConfig(max_batch=4))
    b = serving.ApplyBatcher(eng, ServeConfig(max_batch=4), start=False)
    xs = [rng.randn(5).astype(np.float32) for _ in range(3)]
    reqs = [b.submit(x) for x in xs]
    _drive(b, reqs)
    refs = apply_fn(params, torch.tensor(np.stack(xs + [xs[-1]]))).numpy()   # padded to 4
    for i, req in enumerate(reqs):
        assert req.error is None
        np.testing.assert_array_equal(refs[i], req.output)
    assert eng.device.type == "cpu"


# ------------------------------------------------------------ wire loopback

def test_loopback_server_client_end_to_end(lm, greedy_engine):
    """Concurrent clients against a live continuous-batching server: every
    stream equals its batch-1 generate(), timings are populated, stats and
    ping work, malformed requests get typed errors and the connection
    survives them."""
    server = serving.InferenceServer(Batcher(greedy_engine, greedy_engine.config))
    try:
        rng = np.random.RandomState(11)
        prompts = [rng.randint(1, 97, size=n).astype(np.int32) for n in (5, 9)]
        refs = [_generate(lm, p, 5) for p in prompts]
        results = [None] * len(prompts)

        def hit(i):
            c = serving.ServeClient(server.address)
            try:
                results[i] = c.generate(prompts[i], 5)
            finally:
                c.close()

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        for ref, res in zip(refs, results):
            assert res is not None, "client thread did not finish"
            toks, timing = res
            assert isinstance(toks, np.ndarray)
            np.testing.assert_array_equal(ref, toks)
            assert set(timing) == {"request_id", "queue_s", "prefill_s", "decode_s", "total_s"}
            assert timing["total_s"] >= 0.0 and isinstance(timing["request_id"], int)
        c = serving.ServeClient(server.address)
        try:
            assert c.ping() < 60.0
            st = c.stats()
            assert st["kind"] == "lm" and st["mode"] == "continuous"
            assert st["registry"]["serve.requests.completed"] >= 2
            assert c.status()["kind"] == "serve"
            with pytest.raises(ServeError, match="pad bucket"):
                c.generate(np.arange(100, dtype=np.int32), 5)
            with pytest.raises(ServeError, match="positive int"):
                c.generate(prompts[0], 0)
            with pytest.raises(ServeError, match="'infer' op|LM batcher"):
                c.infer({"x": np.zeros(3, np.float32)})
            reply = c._client.call_raw((123, "nope"), c._client.wire)
            assert reply[0] == "error" and "malformed" in reply[2]
            reply = c._client.call_raw(("warp", 1), c._client.wire)
            assert reply[0] == "error" and "unknown op" in reply[2]
            toks, _ = c.generate(prompts[0], 5)
            np.testing.assert_array_equal(refs[0], toks)
        finally:
            c.close()
    finally:
        server.close()


def test_loopback_apply_server():
    rng = np.random.RandomState(3)
    params = {"w": torch.tensor(rng.randn(4, 2).astype(np.float32))}

    def apply_fn(params, x):
        return x @ params["w"]

    scfg = ServeConfig(max_batch=4)
    server = serving.InferenceServer(
        serving.ApplyBatcher(serving.ApplyEngine(apply_fn, params, scfg), scfg))
    try:
        c = serving.ServeClient(server.address)
        try:
            x = rng.randn(4).astype(np.float32)
            out, _ = c.infer(x)
            np.testing.assert_array_equal(apply_fn(params, torch.tensor(x[None])).numpy()[0],
                                          out)
            with pytest.raises(ServeError, match="'generate' op|apply"):
                c.generate(np.arange(3, dtype=np.int32), 2)
            assert c.stats()["kind"] == "apply"
        finally:
            c.close()
    finally:
        server.close()


def test_slo_metric_families_in_snapshot(greedy_engine):
    from autodist_tpu_torch.telemetry import metrics as tmetrics
    b = Batcher(greedy_engine, greedy_engine.config, start=False)
    req = b.submit(_prompt(4, seed=5), 2)
    _drive(b, [req])
    snap = telemetry.snapshot()
    for fam in ("queue", "prefill", "decode", "total"):
        h = snap[f"serve.latency_s.{fam}"]
        assert h["count"] >= 1
        for edge in tmetrics.MS_BUCKETS:
            assert f"le:{edge:g}" in h
    for name in ("serve.requests.submitted", "serve.requests.completed",
                 "serve.requests.rejected", "serve.queue_depth", "serve.batch_fill"):
        assert name in snap


def test_wire_interop_with_the_jax_package(lm, greedy_engine):
    """A JAX ``ServeClient`` gets from the port's ``InferenceServer`` the
    greedy tokens a JAX server gives it for the same weights, and the port's
    client gets them from the JAX server: the frames are the same."""
    from autodist_tpu import serving as jserving
    from autodist_tpu.models import transformer_lm as jlm
    model, params = lm
    jcfg = jlm.TransformerLMConfig(**SMALL, dtype=jnp.float32)
    jengine = jserving.LMEngine(jlm.TransformerLM(jcfg), to_jax_params(params),
                                jserving.ServeConfig(max_batch=1))
    jserver = jserving.InferenceServer(jserving.Batcher(jengine, jengine.config))
    tserver = serving.InferenceServer(Batcher(greedy_engine, greedy_engine.config))
    prompt = _prompt(6, seed=8)
    try:
        jclient = jserving.ServeClient(jserver.address)
        want, _ = jclient.generate(prompt, 6)
        jclient.close()
        jclient = jserving.ServeClient(tserver.address)
        got, timing = jclient.generate(prompt, 6)
        assert jclient.stats()["kind"] == "lm"
        jclient.close()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert set(timing) >= {"queue_s", "prefill_s", "decode_s", "total_s"}
        tclient = serving.ServeClient(jserver.address)
        again, _ = tclient.generate(prompt, 6)
        tclient.close()
        np.testing.assert_array_equal(again, np.asarray(want))
    finally:
        tserver.close()
        jserver.close()
