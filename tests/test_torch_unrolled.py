"""The port's fused multi-step path (``DistributedRunner.run_many``,
``shard_block``, ``train(..., unroll=K)``, ``prefetch_to_device(unroll=K)``,
``ThroughputMeter.step_many``) against its own ``run()`` and per-step loop,
bit for bit, as ``tests/test_unrolled.py:60-317`` holds the JAX package's;
the launch counters' replay bookkeeping; and ``plan_costs``' static probe.

On the CPU ``run_many`` runs its K steps in order (the card captures them
into one CUDA graph, which ``chip_smoke.py`` phase 16 holds against
``run()``), so every comparison here is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AllReduce, AutoDist
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.data import prefetch
from autodist_tpu_torch.ops import costs
from autodist_tpu_torch.ops import fused_xent as fx
from autodist_tpu_torch.runner import BatchBlock, MicroBatched
from autodist_tpu_torch.training import train
from autodist_tpu_torch.utils.metrics import ThroughputMeter

ONE = {"nodes": [{"address": "localhost", "gpus": [0]}]}
BATCH = 32


def _loss(p, b):
    return ((b["y"] - (b["x"] @ p["w"] + p["b"])) ** 2).mean()


def _params():
    rng = np.random.RandomState(7)
    return {"w": torch.tensor(rng.randn(4, 1).astype(np.float32)), "b": torch.zeros(1)}


def _batch_fn(i):
    rng = np.random.RandomState(100 + i)
    return {"x": rng.randn(BATCH, 4).astype(np.float32),
            "y": rng.randn(BATCH, 1).astype(np.float32)}


def _runner(accum=1, has_aux=False, loss=None):
    ad = AutoDist(resource_info=ONE, strategy_builder=AllReduce(), device="cpu")
    return ad.create_distributed_session(
        loss or _loss, _params(), lambda p: torch.optim.Adam(p, lr=1e-2),
        example_batch=_batch_fn(0), accumulation_steps=accum, has_aux=has_aux)


def _session(**kwargs):
    runner = _runner(**kwargs)
    return runner, runner.init(_params())


def _assert_state_equal(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        sa, sb = a.optimizer.state[a.opt_params[k]], b.optimizer.state[b.opt_params[k]]
        for field in sa:
            assert torch.equal(sa[field], sb[field]), (k, field)


@pytest.mark.parametrize("accum", [1, 2])
def test_run_many_bit_exact_vs_sequential(accum):
    K = 6
    batches = [_batch_fn(i) for i in range(K)]
    runner_a, state_a = _session(accum=accum)
    seq = [runner_a.run(state_a, b)[1] for b in batches]
    runner_b, state_b = _session(accum=accum)
    state_b, losses = runner_b.run_many(state_b, batches)
    assert losses.shape == (K,)
    assert torch.equal(losses, torch.stack(seq))
    _assert_state_equal(state_b, state_a)
    assert state_b.step == state_a.step == K


def test_run_many_single_step_and_repeated_blocks():
    """One-step blocks equal run(); consecutive blocks equal 2K steps."""
    runner_a, state_a = _session()
    loss_a = runner_a.run(state_a, _batch_fn(0))[1]
    runner_b, state_b = _session()
    _, losses_b = runner_b.run_many(state_b, [_batch_fn(0)])
    assert torch.equal(losses_b, loss_a[None])
    _assert_state_equal(state_b, state_a)
    K = 3
    for b in [_batch_fn(i) for i in range(1, 2 * K + 1)]:
        runner_a.run(state_a, b)
    runner_b.run_many(state_b, [_batch_fn(i) for i in range(1, K + 1)])
    runner_b.run_many(state_b, [_batch_fn(i) for i in range(K + 1, 2 * K + 1)])
    _assert_state_equal(state_b, state_a)
    assert state_b.step == 2 * K + 1


def test_run_many_fetches_and_aux_stack_per_step():
    """``fetches=fn`` and aux come back with a leading ``[K]`` axis; slice k
    equals the k-th run()'s (from that step's pre-update params)."""
    def loss_with_aux(p, b):
        per_ex = ((b["y"] - (b["x"] @ p["w"] + p["b"])) ** 2)[:, 0]
        return per_ex.mean(), {"mean_abs": per_ex.abs().mean(), "per_example": per_ex}

    def preds(p, b):
        return b["x"] @ p["w"] + p["b"]

    K = 3
    batches = [_batch_fn(i) for i in range(K)]
    runner_a, state_a = _session(has_aux=True, loss=loss_with_aux)
    seq = [runner_a.run(state_a, b, fetches=preds)[1] for b in batches]
    runner_b, state_b = _session(has_aux=True, loss=loss_with_aux)
    _, ((losses, auxes), stacked) = runner_b.run_many(state_b, batches, fetches=preds)
    assert losses.shape == (K,) and stacked.shape == (K, BATCH, 1)
    assert auxes["per_example"].shape == (K, BATCH) and auxes["mean_abs"].shape == (K,)
    for k, ((loss, aux), fetched) in enumerate(seq):
        assert torch.equal(losses[k], loss) and torch.equal(stacked[k], fetched)
        for key in aux:
            assert torch.equal(auxes[key][k], aux[key]), key
    _assert_state_equal(state_b, state_a)


@pytest.mark.parametrize("accum", [1, 2])
def test_run_many_accepts_prestacked_block(accum):
    """A BatchBlock from shard_block (the unroll feed's) runs as given;
    micro-batched leaves lay out ``[K, k, B/k, ...]``, and batches that
    shard_batch already laid out stack as they are."""
    K = 4
    batches = [_batch_fn(i) for i in range(K)]
    runner, state = _session(accum=accum)
    block = runner.shard_block(batches)
    assert isinstance(block, BatchBlock) and len(block) == K
    leaf = block.tree["x"]
    if accum > 1:
        assert isinstance(leaf, MicroBatched) and tuple(leaf.value.shape) == (K, 2, 16, 4)
    else:
        assert tuple(leaf.shape) == (K, BATCH, 4)
    runner.run_many(state, block)
    laid_out = runner.shard_block([runner.shard_batch(b) for b in batches])
    runner_l, state_l = _session(accum=accum)
    runner_l.run_many(state_l, laid_out)
    runner_a, state_a = _session(accum=accum)
    for b in batches:
        runner_a.run(state_a, b)
    _assert_state_equal(state, state_a)
    _assert_state_equal(state_l, state_a)


def test_shard_block_refuses_mismatched_and_ragged_batches():
    runner = _runner()
    good = _batch_fn(0)
    with pytest.raises(ValueError, match="structure"):
        runner.shard_block([good, {"x": good["x"]}])
    small = {k: v[: BATCH // 2] for k, v in _batch_fn(1).items()}
    with pytest.raises(ValueError, match="uniformly-shaped"):
        runner.shard_block([good, small])
    with pytest.raises(ValueError, match="at least one"):
        runner.shard_block([])


# --------------------------------------------------------------- train(unroll=)

def test_train_unrolled_matches_per_step():
    per_step = train(_runner(), _params(), _batch_fn, steps=10, log_every=0)
    fused = train(_runner(), _params(), _batch_fn, steps=10, log_every=0,
                  unroll=4)    # blocks of 4, 4, 2: steps clips the last
    prefetched = train(_runner(), _params(), _batch_fn, steps=10, log_every=0, unroll=4,
                       prefetch_depth=2)
    assert fused.step == prefetched.step == 10
    _assert_state_equal(fused, per_step)
    _assert_state_equal(prefetched, per_step)


def test_train_unrolled_partial_final_block_on_exhaustion():
    """An iterator that ends mid-block trains the partial block (here with
    the block feed too) and stops with exact step accounting."""
    per_step = train(_runner(), _params(), [_batch_fn(i) for i in range(5)], steps=100,
                     log_every=0)
    for depth in (0, 2):
        fused = train(_runner(), _params(), [_batch_fn(i) for i in range(5)], steps=100,
                      log_every=0, unroll=4, prefetch_depth=depth)   # blocks of 4 then 1
        assert fused.step == 5
        _assert_state_equal(fused, per_step)


def test_train_unrolled_resume_mid_run(tmp_path):
    """Save cadence points end blocks, so an interrupted unrolled run
    resumes where a per-step run would and lands on the same state; an
    iterable source is fast-forwarded."""
    direct = train(_runner(), _params(), _batch_fn, steps=10, log_every=0)
    ckpt = str(tmp_path / "ckpts")
    first = train(_runner(), _params(), _batch_fn, steps=7, log_every=0, unroll=4,
                  checkpoint_dir=ckpt, save_every=3)
    assert first.step == 7
    assert Saver.latest_checkpoint(ckpt).endswith("model-7")
    resumed = train(_runner(), _params(), _batch_fn, steps=10, log_every=0, unroll=4,
                    checkpoint_dir=ckpt, save_every=3)
    assert resumed.step == 10
    _assert_state_equal(resumed, direct)

    items = [_batch_fn(i) for i in range(8)]
    whole = train(_runner(), _params(), list(items), steps=8, log_every=0, unroll=3)
    ckpt = str(tmp_path / "iter")
    train(_runner(), _params(), list(items), steps=4, checkpoint_dir=ckpt, log_every=0,
          unroll=3)
    again = train(_runner(), _params(), list(items), steps=8, checkpoint_dir=ckpt,
                  log_every=0, unroll=3)
    assert again.step == 8
    _assert_state_equal(again, whole)


def test_train_unrolled_eval_cadence_unchanged():
    """eval_every ends blocks: evals fire at the per-step loop's steps."""
    evals = []
    train(_runner(), _params(), _batch_fn, steps=9, log_every=0, unroll=4, eval_every=3,
          eval_batch=_batch_fn(999), on_eval=lambda step, val: evals.append((step, float(val))))
    assert [s for s, _ in evals] == [3, 6, 9]
    assert evals[-1][1] < evals[0][1]


def test_train_unrolled_metrics_at_block_granularity():
    """The first block is the warm-up; a period closes at the first block end
    with >= log_every post-warm-up steps; unroll=1 stays the per-step loop."""
    seen = []
    train(_runner(), _params(), _batch_fn, steps=8, log_every=3, unroll=4,
          on_metrics=lambda step, loss, rate: seen.append((step, loss, rate)))
    assert [s for s, _, _ in seen] == [8]
    assert all(rate > 0 and np.isfinite(loss) for _, loss, rate in seen)
    steps = []
    train(_runner(), _params(), _batch_fn, steps=7, log_every=3, unroll=1,
          on_metrics=lambda step, loss, rate: steps.append(step))
    assert steps == [4, 7]


def test_meter_step_many_periods():
    meter = ThroughputMeter(batch_size=10, log_every=3)
    assert meter.step_many(4, sync=torch.ones(4)) is None        # warm-up block
    assert meter.step_many(2, sync=torch.ones(2)) is None        # 2 < 3 steps
    rate = meter.step_many(2, sync=torch.ones(2))                # 4 >= 3: a period
    assert rate is not None and rate > 0 and meter.history == [rate]
    assert meter.step_many(0) is None
    assert meter.finish() > 0


def test_train_adopts_the_tuned_unroll():
    """``unroll=None`` takes ``runner.tuned_plan``'s; an explicit one wins."""
    from autodist_tpu_torch.strategy.autotune import TunedPlan
    blocks = []

    def runner_with_plan(unroll):
        runner = _runner()
        runner.tuned_plan = TunedPlan({"name": "AllReduce"}, unroll=unroll)
        run_many = runner.run_many

        def counted(state, block, fetches=None):
            blocks.append(len(block))
            return run_many(state, block, fetches)

        runner.run_many = counted
        return runner

    train(runner_with_plan(4), _params(), _batch_fn, steps=8, log_every=0)
    assert blocks == [4, 4]
    train(runner_with_plan(4), _params(), _batch_fn, steps=3, log_every=0, unroll=1)
    assert blocks == [4, 4]


def test_prefetch_to_device_yields_blocks():
    """unroll=K emits BatchBlocks of K batches in order and drops a partial
    remainder (as the JAX package does); per_host takes unroll=1 only."""
    runner, state = _session()
    items = [_batch_fn(i) for i in range(5)]
    with prefetch.prefetch_to_device(items, runner, depth=2, unroll=2) as feed:
        blocks = list(feed)
    assert [len(b) for b in blocks] == [2, 2]
    for j, block in enumerate(blocks):
        for i in range(2):
            np.testing.assert_array_equal(block.tree["x"][i].numpy(), items[2 * j + i]["x"])
        runner.run_many(state, block)
    assert state.step == 4
    with pytest.raises(ValueError, match="per_host"):
        prefetch.prefetch_to_device(items, runner, unroll=2, per_host=True)


def test_launch_counters_advance_through_replay_bookkeeping():
    """What a capture counted is undone at once (a capture launches
    nothing) and added again by every replay, as run_many does on the
    card."""
    before = costs.launch_counts()
    with costs.recorded_launches() as per_replay:
        fx.xent_fwd.launches += 2          # the wrappers' count during a capture
        fx.xent_pack_w.launches += 4
    assert per_replay == {"xent_fwd": 2, "xent_pack_w": 4}
    assert costs.launch_counts() == before
    for _ in range(3):
        costs.add_launches(per_replay)
    after = costs.launch_counts()
    assert after["xent_fwd"] == before["xent_fwd"] + 6
    assert after["xent_pack_w"] == before["xent_pack_w"] + 12
    assert after["xent_dh"] == before["xent_dh"]
    for fn in costs.counted_wrappers():
        fn.launches = before[fn.__name__]


def test_plan_costs_counts_a_step_without_running_it():
    """plan_costs traces on fake tensors: the state is untouched, a K-step
    record is K steps' work in one launch, and the fused head's record holds
    the kernels' own HBM bytes, far below its plain version's."""
    runner, state = _session(accum=2)
    w = state.params["w"].clone()
    one = runner.plan_costs(_params(), _batch_fn(0))
    four = runner.plan_costs(_params(), _batch_fn(0), unroll=4)
    assert torch.equal(state.params["w"], w) and state.step == 0
    # Each of the 2 micro-batches of 16 rows: x @ w and its gradient in w.
    assert one["flops"] == 2 * (2 * 16 * 4 + 2 * 4 * 16)
    assert one["launches"] > 4 and one["steps"] == one["dispatches"] == 1
    assert four == {"flops": 4 * one["flops"], "bytes_accessed": 4 * one["bytes_accessed"],
                    "steps": 4, "dispatches": 1, "launches": 1, "source": "fake-trace"}

    from autodist_tpu_torch.models import transformer_lm as tlm
    cfg = tlm.TransformerLMConfig(vocab_size=512, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                                  max_len=32, dtype=torch.float32, tied_output=False,
                                  fused_head=True)
    plain_cfg = dataclasses.replace(cfg, fused_head=False)
    model, params = tlm.init_params(cfg, seed=0, device="cpu")
    batch = tlm.synthetic_batch(cfg, 8, 16)
    records = {}
    for label, c in (("fused", cfg), ("plain", plain_cfg)):
        records[label] = AutoDist(resource_info=ONE, strategy_builder=AllReduce(),
                                  device="cpu").create_distributed_session(
            tlm.make_loss_fn(tlm.TransformerLM(c)), params,
            lambda p: torch.optim.Adam(p, lr=1e-3)).plan_costs(params, batch)
    # The logits [128, 512] f32 and their gradient never reach memory.
    assert records["fused"]["bytes_accessed"] < records["plain"]["bytes_accessed"] - 3 * 128 * 512 * 4
    assert records["fused"]["flops"] > 0


def test_unroll_sweep_entry_point_on_the_host(capsys):
    """``examples.benchmark.unroll`` prints bench.py's keys (a steps/s row by
    factor, the largest factor's speedup over unroll 1) and whether its
    block equalled run() bit for bit."""
    import json
    from autodist_tpu_torch.examples.benchmark import unroll
    result = unroll.main(["--device", "cpu", "--factors", "1,2", "--steps", "4"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert set(result) == {"metric", "unit", "rows", "tokens_per_step", "best_factor",
                           "speedup_vs_unroll1", "bit_identical"}
    assert result["bit_identical"] is True
    assert set(result["rows"]) == {"1", "2"} and all(v > 0 for v in result["rows"].values())
