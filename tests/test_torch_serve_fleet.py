"""The port's fleet serving (autodist_tpu_torch.serving): the paged KV
engine, the router, and the serving export, on the CPU.

tests/test_serve_fleet.py's contract, on the port:
- page allocator and page-bucket units;
- the paged engine's tokens EQUAL the dense engine's through the real
  batcher, greedy and sampled, with shared-prefix admits in play; that rests
  on three properties of the decode path, each held here directly: width
  invariance (a ``K * page_len``-wide context gives the full-width logits
  bit for bit), split-prefill exactness (a prefix then its suffix equals
  the one-shot prefill), and row independence at a fixed batch;
- a prefix hit gives the same tokens and books ``serve.kv.prefix_hits``;
- freed pages poisoned with bounded garbage stay invisible;
- pool exhaustion holds admission back (FIFO) and sheds a typed
  ``ServeBusy`` at the queue bound; an impossible request is rejected;
- the router: least-loaded spread, the typed shed cascade, replay with the
  same rid around a killed replica (zero client-visible failures, a booked
  respawn), replica-side rid dedup, drain and scale-out on
  ``serve_p99_burn``, the ``worker_crash`` fault hook, the flags;
- the export: ``torch.export`` round trip at any batch, served with the
  model code made unusable, stale graphs swept, another device refused.
Replicas are in-process ``InferenceServer``s on loopback, killed with
``kill()``. Every thread and socket wait has its own bound.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.checkpoint.saved_model_builder import SavedModelBuilder
from autodist_tpu_torch.coordinator import RespawnPolicy
from autodist_tpu_torch.models import transformer_lm as tlm
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.serving import (Batcher, InferenceServer, LMEngine, PageAllocator,
                                        PagedLMEngine, Router, RouterServer, ServeBusy,
                                        ServeClient, ServeConfig, ServeError, default_buckets,
                                        page_buckets)
from autodist_tpu_torch.telemetry import memplane
from autodist_tpu_torch.testing import faults

SMALL = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=64)
PAGE = 16
JOIN_S = 60.0


@pytest.fixture(scope="module")
def lm():
    return tlm.init_params(tlm.TransformerLMConfig(**SMALL, dtype=torch.float32), seed=3,
                           device="cpu")


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 97, size=n).astype(np.int32)


def _drive(batcher, reqs, rounds=300):
    for _ in range(rounds):
        if all(r.done.is_set() for r in reqs):
            break
        batcher.run_once()
    assert all(r.done.is_set() for r in reqs), "batcher did not converge"


def _tokens_via_batcher(engine, config, requests):
    b = Batcher(engine, config, start=False)
    reqs = [b.submit(p, n, seed=s) for p, n, s in requests]
    _drive(b, reqs)
    for r in reqs:
        assert r.error is None, r.error
    return [tuple(r.tokens) for r in reqs]


def _counter(name):
    v = telemetry.snapshot().get(name)
    return int(v) if isinstance(v, (int, float)) else 0


# --------------------------------------------------- page allocator units

def test_page_buckets_pow2_with_exact_max():
    assert page_buckets(8) == (1, 2, 4, 8)
    assert page_buckets(5) == (1, 2, 4, 5)
    assert page_buckets(1) == (1,)


def test_page_allocator_reserve_alloc_refcount():
    al = PageAllocator(5)
    assert al.usable == 4 and al.free_count() == 4
    al.reserve(3)
    assert al.available() == 1
    with pytest.raises(ServeError):
        al.reserve(2)
    pages = [al.alloc() for _ in range(3)]
    assert 0 not in pages and len(set(pages)) == 3
    assert al.free_count() == 1 and al.available() == 1
    al.retain(pages[0])
    al.release(pages[0])
    assert al.free_count() == 1
    al.release(pages[0])
    assert al.free_count() == 2
    for p in pages[1:]:
        al.release(p)
    assert al.free_count() == 4
    al.reserve(1)
    al.alloc()
    with pytest.raises(AssertionError):
        al.alloc()                 # beyond the reservation: a programming error


# ------------------------------------- the three properties paging rests on

def _sub(model, params, width):
    sub = tlm.TransformerLM(dataclasses.replace(model.config, max_len=width))
    return sub, {**params, "pos_embed": params["pos_embed"][:width]}


def test_width_split_prefill_and_row_independence_are_exact(lm):
    """(1) a per-row decode over a 16- or 32-wide context equals the same
    step over the 64-wide cache bit for bit (the junk beyond each frontier
    finite); (2) prefilling a 16-token prefix, then its suffix at
    ``cache_index = pos_offset = 16``, equals the one-shot prefill, cache and
    last hidden state; (3) a row's logits at a fixed batch do not depend on
    the other rows' contents."""
    model, params = lm
    toks = torch.tensor(np.stack([_prompt(20, seed=s) for s in (1, 2)])).long()
    full = tlm.init_cache(model.config, 2, "cpu")
    for v in full.values():
        if v.dim():
            v.normal_(generator=torch.Generator().manual_seed(9))
    tlm.apply(model, params, toks, decode=True, cache=full)
    pos = torch.tensor([5, 11])
    step = torch.tensor([[7], [9]])
    for width in (16, 32):
        sub, sparams = _sub(model, params, width)
        cut = {k: (v[:, :width].clone() if v.dim() else v.clone()) for k, v in full.items()}
        want = tlm.apply(model, params, step, pos_offset=pos, decode=True,
                         cache={k: v.clone() for k, v in full.items()})
        got = tlm.apply(sub, sparams, step, pos_offset=pos, decode=True, cache=cut)
        assert torch.equal(got, want), width
    one = tlm.init_cache(model.config, 1, "cpu")
    h_one = tlm.apply(model, params, toks[:1], decode=True, return_hidden=True, cache=one)
    split = tlm.init_cache(model.config, 1, "cpu")
    tlm.apply(model, params, toks[:1, :16], decode=True, cache=split)
    h_split = tlm.apply(model, params, toks[:1, 16:], pos_offset=16, decode=True,
                        return_hidden=True, cache=split)
    assert torch.equal(h_split[:, -1], h_one[:, -1])
    for key, value in one.items():
        assert torch.equal(split[key], value), key
    mates = torch.tensor([[7], [50]])
    other = tlm.apply(model, params, mates, pos_offset=torch.tensor([5, 3]), decode=True,
                      cache={k: v.clone() for k, v in full.items()})
    first = tlm.apply(model, params, step, pos_offset=pos, decode=True,
                      cache={k: v.clone() for k, v in full.items()})
    assert torch.equal(other[0], first[0])


# --------------------------------------------- paged vs dense bit-identity

_SHARED = _prompt(PAGE, seed=7)
_REQUESTS = [
    (_prompt(5, seed=1), 4, 0),
    (np.concatenate([_SHARED, _prompt(6, seed=2)]), 5, 1),
    (_prompt(12, seed=3), 3, 2),
    (np.concatenate([_SHARED, _prompt(3, seed=4)]), 6, 3),
    (_prompt(1, seed=5), 4, 4),
    (np.concatenate([_SHARED, _prompt(9, seed=6)]), 2, 5),
    (_prompt(40, seed=8), 9, 6),
]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_paged_matches_dense_bit_identical(lm, temperature):
    """The paged engine's streams equal the dense engine's, greedy and
    sampled, through the real batcher with prefix sharing in play; pages
    lift concurrency past the slot count at the same KV bytes; the step
    shapes stay within the (page bucket, prompt bucket) bound."""
    model, params = lm
    dense_cfg = ServeConfig(max_batch=2, temperature=temperature)
    paged_cfg = ServeConfig(max_batch=2, temperature=temperature, page_len=PAGE)
    dense_engine = LMEngine(model, params, dense_cfg)
    dense = _tokens_via_batcher(dense_engine, dense_cfg, _REQUESTS)
    engine = PagedLMEngine(model, params, paged_cfg)
    paged = _tokens_via_batcher(engine, paged_cfg, _REQUESTS)
    assert paged == dense
    assert engine.capacity > dense_cfg.max_batch
    assert engine.kv_bytes() == dense_engine.kv_bytes() + dense_engine.kv_bytes() // (
        dense_cfg.max_batch * engine.max_pages)          # + the scratch page
    n_prefill, n_total = engine.compiled_programs()
    assert n_prefill <= len(engine.buckets) * len(page_buckets(engine.max_pages))
    assert n_total - n_prefill <= len(page_buckets(engine.max_pages))
    assert memplane.census().get("kv_pages", 0) >= engine.kv_bytes()


def test_prefix_cache_hit_identical_tokens(lm):
    model, params = lm
    requests = [(np.concatenate([_SHARED, _prompt(4, seed=11)]), 4, 0),
                (np.concatenate([_SHARED, _prompt(7, seed=12)]), 4, 1)]
    nocache_cfg = ServeConfig(max_batch=2, page_len=PAGE, prefix_cache=False)
    want = _tokens_via_batcher(PagedLMEngine(model, params, nocache_cfg), nocache_cfg,
                               requests)
    hits0 = _counter("serve.kv.prefix_hits")
    cfg = ServeConfig(max_batch=2, page_len=PAGE)
    engine = PagedLMEngine(model, params, cfg)
    assert _tokens_via_batcher(engine, cfg, requests) == want
    assert _counter("serve.kv.prefix_hits") > hits0
    assert engine.pool_snapshot()["prefix_entries"] >= 1


def test_page_reuse_staleness_poisoned_pages_are_invisible(lm):
    """Freed pages keep their stale K/V; poisoned with bounded garbage
    (finite, far below the -1e9 mask) they change no later token."""
    model, params = lm
    cfg = ServeConfig(max_batch=2, page_len=PAGE, prefix_cache=False)
    probe = [(_prompt(20, seed=21), 5, 3)]
    want = _tokens_via_batcher(PagedLMEngine(model, params, cfg), cfg, probe)
    engine = PagedLMEngine(model, params, cfg)
    _tokens_via_batcher(engine, cfg, [(_prompt(30, seed=22), 6, 1), (_prompt(3, seed=23), 8, 2)])
    assert engine.num_active == 0
    free_pages = torch.tensor(engine._alloc._free, dtype=torch.long)
    assert free_pages.numel() > 0
    for leaf in engine._pool.values():
        leaf[free_pages] = 53.0
    assert _tokens_via_batcher(engine, cfg, probe) == want


def test_page_exhaustion_holds_back_then_sheds(lm):
    model, params = lm
    # 3 usable pages; a 20-prompt/16-new request reserves all 3.
    cfg = ServeConfig(max_batch=3, page_len=PAGE, kv_pages=4, max_queue=2, prefix_cache=False)
    engine = PagedLMEngine(model, params, cfg)
    b = Batcher(engine, cfg, start=False)
    reqs = [b.submit(_prompt(20, seed=31), 16, seed=0)]
    b.run_once()
    assert engine.num_active == 1
    reqs += [b.submit(_prompt(20, seed=32 + i), 16, seed=1 + i) for i in range(2)]
    b.run_once()
    assert engine.num_active == 1
    reqs.append(b.submit(_prompt(4, seed=40), 4, seed=9))
    with pytest.raises(ServeBusy):
        b.submit(_prompt(4, seed=41), 4, seed=10)
    _drive(b, reqs)
    assert all(r.error is None for r in reqs)
    doomed = b.submit(_prompt(40, seed=42), 20, seed=11)
    b.run_once()
    assert doomed.done.is_set() and "KV pages" in (doomed.error or "")
    assert engine._alloc.available() == engine._alloc.usable


# ------------------------------------------------------------- router units

class FakeEngine:
    """Deterministic model-free engine; an optional per-step delay keeps
    requests in flight long enough to be killed mid-generation."""

    def __init__(self, capacity=2, max_len=32, step_s=0.0):
        self.capacity = capacity
        self.max_len = max_len
        self.buckets = default_buckets(max_len)
        self.admits = []
        self._steps = np.zeros(capacity, np.int64)
        self._step_s = step_s

    def make_keys(self, seed, n):
        return None

    def admit(self, slot, prompt, key):
        self.admits.append((slot, int(prompt.size)))
        self._steps[slot] = 0
        return 100 * slot

    def step(self, keys):
        if self._step_s:
            time.sleep(self._step_s)
        self._steps += 1
        return (100 * np.arange(self.capacity) + self._steps).astype(np.int32)

    def free(self, slot):
        pass


def _replica_factory(capacity=2, max_queue=8, step_s=0.0, engines=None):
    def factory():
        engine = FakeEngine(capacity=capacity, step_s=step_s)
        if engines is not None:
            engines.append(engine)
        return InferenceServer(Batcher(engine, ServeConfig(max_batch=capacity,
                                                           max_queue=max_queue)), port=0)
    return factory


@pytest.fixture
def clean_fleet_state():
    _recovery.reset()
    faults.clear()
    yield
    faults.clear()


def _run_threads(fn, n):
    results, errors = [], []

    def one(i):
        try:
            results.append(fn(i))
        except Exception as e:   # noqa: BLE001 - the caller's assert reports it
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"
    return results, errors


def test_router_routes_and_spreads(clean_fleet_state):
    engines = []
    router = Router(_replica_factory(step_s=0.002, engines=engines), n_replicas=2, start=False)
    server = RouterServer(router)
    routed0 = _counter("serve.router.routed")
    try:
        tokens, timing = ServeClient(server.address).generate(np.arange(1, 5), 3, seed=0)
        assert tokens.tolist() == [0, 1, 2] and "total_s" in timing
        results, errors = _run_threads(lambda i: ServeClient(server.address).generate(
            np.arange(1, 4), 4, seed=i)[0].tolist(), 8)
        assert not errors and len(results) == 8
        assert _counter("serve.router.routed") - routed0 == 9
        assert all(engine.admits for engine in engines)
        assert ServeClient(server.address).status()["kind"] == "router"
    finally:
        server.close()


def test_router_sheds_typed_busy_when_all_replicas_full(clean_fleet_state):
    servers = []

    def factory():
        b = Batcher(FakeEngine(capacity=1), ServeConfig(max_batch=1, max_queue=1), start=False)
        servers.append(InferenceServer(b, port=0))
        return servers[-1]

    router = Router(factory, n_replicas=2, start=False)
    server = RouterServer(router)
    shed0 = _counter("serve.router.shed")
    try:
        for rep in servers:
            rep._batcher.submit(np.arange(1, 3), 2, seed=0)
        with pytest.raises(ServeBusy):
            ServeClient(server.address).generate(np.arange(1, 3), 2, seed=1)
        assert _counter("serve.router.shed") - shed0 == 1
    finally:
        server.close()


def test_kill_a_replica_completes_all_requests_zero_failures(clean_fleet_state, monkeypatch):
    monkeypatch.setattr(Router, "RESPAWN_BACKOFF_S", 0.02)
    router = Router(_replica_factory(step_s=0.01), n_replicas=2, start=False)
    server = RouterServer(router)
    replayed0 = _counter("serve.router.replayed")
    try:
        victim = router.replicas()[0]

        def killer():
            deadline = time.monotonic() + 10.0
            while victim.load() == 0 and time.monotonic() < deadline:
                time.sleep(0.001)
            victim.server.kill()

        kt = threading.Thread(target=killer)
        kt.start()
        results, errors = _run_threads(lambda i: ServeClient(server.address).generate(
            np.arange(1, 4), 8, seed=i)[0].tolist(), 6)
        kt.join(timeout=JOIN_S)
        assert errors == [] and len(results) == 6
        assert _counter("serve.router.replayed") > replayed0
        counts = _recovery.recovery_snapshot()["counts"]
        assert counts["evicted"] >= 1 and counts["respawns"] >= 1 and counts["rejoined"] >= 1
        live = [r for r in router.replicas() if not r.is_down()]
        assert len(live) == 2 and max(r.generation for r in live) == 1
        tokens, _ = ServeClient(server.address).generate(np.arange(1, 3), 2, seed=99)
        assert len(tokens) == 2
    finally:
        server.close()


def test_rid_dedup_replay_is_idempotent(clean_fleet_state):
    from autodist_tpu_torch.parallel.ps_transport import _PSClient
    engine = FakeEngine(capacity=1)
    server = InferenceServer(Batcher(engine, ServeConfig(max_batch=1)), port=0)
    try:
        client = _PSClient(server.address, connect_timeout=10.0)
        try:
            prompt = np.arange(1, 4).astype(np.int32)
            first = client.call("generate", prompt, 3, 0, None, "rid-x")
            again = client.call("generate", prompt, 3, 0, None, "rid-x")
            assert torch.equal(first[0], again[0]) and first[1] == again[1]
            assert len(engine.admits) == 1
        finally:
            client.close()
    finally:
        server.close()


def test_router_drains_and_scales_out_on_alert(clean_fleet_state, monkeypatch):
    monkeypatch.setattr(Router, "RESPAWN_BACKOFF_S", 0.01)
    router = Router(_replica_factory(), n_replicas=2, start=False)
    try:
        burning = router.replicas()[0]
        real_call = burning.call
        burn_status = {"alerts": {"active": [{"rule": "serve_p99_burn"}]}}
        burning.call = lambda op, *a: (burn_status,) if op == "status" else real_call(op, *a)
        router.poll_once()
        assert burning.draining and len(router.replicas()) == 3
        assert router._pick([]) is not burning
        assert _recovery.recovery_snapshot()["counts"]["rejoined"] >= 1
        burning.call = real_call
        router.poll_once()
        assert not burning.draining
        burning.call = lambda op, *a: (burn_status,) if op == "status" else real_call(op, *a)
        for _ in range(router.max_replicas + 2):
            router.poll_once()
        assert len(router.replicas()) <= router.max_replicas
    finally:
        router.close()


def test_fault_hook_kills_replica_deterministically(clean_fleet_state, monkeypatch):
    monkeypatch.setattr(Router, "RESPAWN_BACKOFF_S", 0.02)
    router = Router(_replica_factory(), n_replicas=2, start=False)
    server = RouterServer(router)
    try:
        faults.install("worker_crash@step=1")
        client = ServeClient(server.address)
        assert len(client.generate(np.arange(1, 3), 2, seed=0)[0]) == 2   # seq 0: clean
        assert len(client.generate(np.arange(1, 3), 2, seed=1)[0]) == 2   # seq 1: killed
        counts = _recovery.recovery_snapshot()["counts"]
        assert counts["evicted"] == 1 and counts["respawns"] == 1
    finally:
        server.close()


def test_respawn_policy_budget_and_fleet_flags(clean_fleet_state, monkeypatch):
    policy = RespawnPolicy(base_s=0.0, cap_s=0.0)
    budget = policy.budget()
    assert all(policy.grant("10.0.0.9:7000") is not None for _ in range(budget))
    assert policy.grant("10.0.0.9:7000") is None
    assert policy.grant("10.0.0.8:7000") is not None
    assert _recovery.recovery_snapshot()["counts"]["respawns"] == budget + 1
    assert const.ENV.AUTODIST_SERVE_REPLICAS.val == 2
    assert const.ENV.AUTODIST_KV_PAGE_LEN.val == 0
    assert const.ENV.AUTODIST_PREFIX_CACHE.val is True
    assert const.ENV.AUTODIST_ROUTER_ADDR.val == ""
    monkeypatch.setenv("AUTODIST_KV_PAGE_LEN", "16")
    monkeypatch.setenv("AUTODIST_PREFIX_CACHE", "0")
    cfg = ServeConfig.from_env()
    assert cfg.page_len == 16 and cfg.prefix_cache is False


# -------------------------------------------------------------- the export

def test_export_round_trip_and_serving_without_model_code(lm, tmp_path, monkeypatch):
    model, params = lm
    export_dir = str(tmp_path / "serve_lm")

    def apply_fn(p, tokens):
        return tlm.apply(model, p, tokens)

    toks = torch.tensor(np.stack([_prompt(8, seed=s) for s in (1, 2)])).long()
    SavedModelBuilder(export_dir).save(params, model_config={"family": "transformer_lm"},
                                       apply_fn=apply_fn, example_args=(toks,),
                                       polymorphic_batch=True)
    for name in ("params.npz", "model_config.json", "apply.export", "apply.hlo"):
        assert os.path.exists(os.path.join(export_dir, name)), name
    loaded = SavedModelBuilder.load_params(export_dir)
    for key, value in params.items():
        assert torch.equal(loaded[key], value), key
    serve = SavedModelBuilder.load_serving_fn(export_dir)
    for batch in (1, 3):
        x = torch.tensor(np.stack([_prompt(8, seed=s) for s in range(batch)])).long()
        torch.testing.assert_close(serve(loaded, x), apply_fn(params, x), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        SavedModelBuilder.load_serving_fn(export_dir, device="cuda")
    # The artifact runs with the model code made unusable: the graph comes
    # from apply.export, the params from params.npz.
    want = apply_fn(params, toks)

    def unusable(*args, **kwargs):
        raise AssertionError("the serving artifact called model code")

    monkeypatch.setattr(tlm, "apply", unusable)
    monkeypatch.setattr(tlm.TransformerLM, "forward", unusable)
    fresh = SavedModelBuilder.load_serving_fn(export_dir, device="cpu")
    torch.testing.assert_close(fresh(SavedModelBuilder.load_params(export_dir), toks), want,
                               rtol=1e-6, atol=1e-6)
    SavedModelBuilder(export_dir).save(params, model_config={"family": "transformer_lm"})
    for name in ("apply.export", "apply.hlo", "apply.device"):
        assert not os.path.exists(os.path.join(export_dir, name)), name
