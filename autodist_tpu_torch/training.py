"""Training loop with automatic checkpoint and resume (the port's copy of
``train`` in ``autodist_tpu/training.py:76-808``): periodic chief-gated saves
under the JAX package's names, resume from the latest checkpoint, throughput
metering, evaluation cadence, the prefetching device feed, a final save, so
a run restarted with the same command continues where it stopped; and the
fused loop of ``unroll=K`` (``_unrolled_loop``), which runs blocks of K
steps through ``runner.run_many`` (one CUDA graph replay a block on the
card) while the host gathers the next block.

Not ported yet, and each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: ``health_monitor``, the recover ring, and the planes
the environment can arm (``const.UNPORTED_PLANES``).
"""

import logging
import os
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.data import prefetch as _prefetch
from autodist_tpu_torch.runner import BatchBlock, MicroBatched, ShardedBatch, TrainState, _leaves
from autodist_tpu_torch.testing import faults as _faults
from autodist_tpu_torch.utils.metrics import ThroughputMeter

_log = logging.getLogger("autodist_tpu_torch")

PLANES_ROADMAP = "ROADMAP.md, Queue 1 item 7: train()'s health, recover, profiling, " \
                 "history, telemetry and openmetrics hooks"


def _make_meter(first_batch, batch_size: Optional[int], log_every: int,
                dp: int) -> ThroughputMeter:
    """A meter sized from the first batch: its largest leading dim (a
    micro-batched leaf counts ``k * rows``); a batch the feed already laid
    out holds this rank's ``1/dp`` of the rows."""
    n = batch_size
    if n is None:
        dims = []
        for leaf in _leaves(first_batch):
            if isinstance(leaf, MicroBatched):
                if leaf.value.dim() >= 2:
                    dims.append(leaf.value.shape[0] * leaf.value.shape[1])
            elif np.ndim(leaf) >= 1:
                dims.append(int(np.shape(leaf)[0]))
        n = max(dims, default=1)
        if isinstance(first_batch, ShardedBatch):
            n *= dp
    return ThroughputMeter(batch_size=n, log_every=log_every)


def _refuse_unported(health_monitor) -> None:
    if health_monitor is not None:
        raise NotImplementedError(f"train(health_monitor=...) is not ported yet "
                                  f"({PLANES_ROADMAP})")
    armed = [f"{name} ({what})" for name, what in const.UNPORTED_PLANES.items()
             if const.env_armed(name)]
    if armed:
        raise NotImplementedError(f"{', '.join(armed)} armed in the environment, but "
                                  f"train() has no such plane yet ({PLANES_ROADMAP}); "
                                  f"unset it to train without it")


def train(runner, params, batches: Union[Callable[[int], Any], Iterable[Any]],
          steps: int,
          checkpoint_dir: Optional[str] = None,
          checkpoint_name: str = "model",
          save_every: int = 1000,
          max_to_keep: int = 5,
          log_every: int = 100,
          batch_size: Optional[int] = None,
          is_chief: Optional[bool] = None,
          resume: bool = True,
          async_save: bool = False,
          on_metrics: Optional[Callable[[int, float, float], None]] = None,
          eval_every: int = 0,
          eval_batch: Any = None,
          eval_fn: Optional[Callable] = None,
          on_eval: Optional[Callable[[int, Any], None]] = None,
          unroll: Optional[int] = None,
          prefetch_depth: Optional[int] = None,
          health_monitor=None,
          sharded: Optional[bool] = None) -> TrainState:
    """Run ``steps`` global steps, checkpointing and resuming automatically.

    ``batches``: ``fn(step_index) -> batch`` or an iterable of batches
    (exhaustion ends the run early); every rank passes the global batch and
    keeps its rows. With several ranks every rank calls this together: saves
    are collective (rank 0 writes), resumes read the shared directory.
    Periodic saves fire every ``save_every`` steps from the chief
    (``is_chief``, default :func:`autodist_tpu_torch.const.is_chief_process`);
    ``async_save`` writes them behind the loop; the final save, when the run
    advanced, is synchronous, so the returned state is on disk. ``resume``
    restores ``latest_checkpoint`` and fast-forwards an iterable source so
    step i still consumes batch i. ``on_metrics(step, loss, rate)`` fires
    every ``log_every`` steps after the first (warm-up) step; with
    ``eval_every`` and ``eval_batch`` the runner's ``evaluate`` runs every
    ``eval_every`` steps (``eval_fn`` defaults to the loss) and
    ``on_eval(step, value)`` gets the value. ``prefetch_depth`` (default
    ``AUTODIST_PREFETCH_DEPTH``, 0 = the synchronous feed) pulls and places
    that many batches ahead through
    :func:`autodist_tpu_torch.data.prefetch.device_feed`; the source's
    exceptions re-raise at the consuming step. ``sharded`` picks every
    save's format (:meth:`Saver.save`: None writes the sharded v2 format when
    some tensor is sharded across ranks). Returns the final state.

    ``unroll=None`` adopts the tuned plan's ``unroll`` when the runner has
    one (``runner.tuned_plan``, set by ``AutoDist(strategy_builder=
    "autotune")`` or ``create_distributed_session(tune=True)``), else 1;
    ``prefetch_depth=None`` adopts its nonzero ``prefetch_depth`` likewise.
    ``unroll=K > 1`` runs blocks of up to K steps through
    ``runner.run_many`` (bit-identical to K per-step calls), gathering and
    placing the next block while the device runs the last; save and eval
    cadences end blocks, so saves, evals and resumes fall on the per-step
    loop's steps, and only metering moves to block granularity (the first
    block is the meter's warm-up; ``on_metrics`` gets the block's last
    loss). With ``prefetch_depth`` the feed assembles and places blocks
    ``prefetch_depth`` blocks ahead. On the card a plan that
    ``run_many`` cannot capture raises its ``RuntimeError``."""
    _refuse_unported(health_monitor)
    tuned = getattr(runner, "tuned_plan", None)
    if unroll is None:
        unroll = int(getattr(tuned, "unroll", 1) or 1)
        if unroll > 1:
            _log.info("train: adopting tuned plan unroll=%d (%s; pass unroll= explicitly "
                      "to override)", unroll, getattr(tuned, "name", "tuned plan"))
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    if prefetch_depth is None:
        tuned_depth = int(getattr(tuned, "prefetch_depth", 0) or 0)
        if tuned_depth > 0:
            _log.info("train: adopting tuned plan prefetch_depth=%d (pass prefetch_depth= "
                      "explicitly to override)", tuned_depth)
            prefetch_depth = tuned_depth
        else:
            prefetch_depth = _prefetch.default_prefetch_depth()
    prefetch_depth = max(0, int(prefetch_depth))
    if eval_every and eval_batch is None:
        raise ValueError("eval_every needs an eval_batch")
    if is_chief is None:
        is_chief = const.is_chief_process()
    # Saves are collective across ranks: every rank calls save, rank 0 writes.
    save_participant = is_chief or (dist.is_initialized() and dist.get_world_size() > 1)
    saver = Saver(max_to_keep=max_to_keep) if checkpoint_dir else None
    prefix_base = os.path.join(checkpoint_dir, checkpoint_name) if checkpoint_dir else None

    state = None
    if saver is not None and resume:
        latest = Saver.latest_checkpoint(checkpoint_dir, name=checkpoint_name)
        if latest is not None:
            state = saver.restore(latest, runner=runner)
            _log.info("train: resumed from %s at step %d", latest, state.step)
    if state is None:
        state = runner.init(params)

    next_batch = batches if callable(batches) else None
    batch_iter = iter(batches) if next_batch is None else None
    start = state.step
    if batch_iter is not None and start > 0:
        _log.info("train: fast-forwarding batch iterator by %d consumed steps", start)
        for _ in range(start):
            try:
                next(batch_iter)
            except StopIteration:
                return state

    if unroll > 1 and not getattr(runner, "supports_run_many", True):
        _log.warning("train: unroll=%d requested but %s has no fused multi-step path (async "
                     "regime); falling back to per-step dispatch", unroll, type(runner).__name__)
        unroll = 1
    feed = None
    try:
        if unroll > 1:
            next_boundary = _boundary_fn(steps, save_every if saver is not None else 0,
                                         eval_every)
            if prefetch_depth > 0:
                feed = _BlockFeed(runner, next_batch, batch_iter, start, steps, unroll,
                                  next_boundary, prefetch_depth)
            state = _unrolled_loop(runner, state, next_batch, batch_iter, start, steps,
                                   unroll, saver, prefix_base, save_participant, save_every,
                                   async_save, log_every, batch_size, on_metrics, eval_every,
                                   eval_batch, eval_fn, on_eval, sharded, feed)
        else:
            if prefetch_depth > 0:
                feed = _step_feed(runner, next_batch, batch_iter, start, steps,
                                  prefetch_depth)
            state = _per_step_loop(runner, state, feed, next_batch, batch_iter, start, steps,
                                   saver, prefix_base, save_participant, save_every,
                                   async_save, log_every, batch_size, on_metrics, eval_every,
                                   eval_batch, eval_fn, on_eval, sharded)
    finally:
        if feed is not None:
            feed.close()
    # The final save stays synchronous: returning means the state is on disk.
    if saver is not None and save_participant and state.step > start:
        saver.save(state, prefix_base, sharded=sharded)
    if saver is not None:
        saver.wait()
    return state


def _step_feed(runner, next_batch, batch_iter, start: int, steps: int, depth: int,
               workers: Optional[int] = None):
    """The loop's async feed: the source pulled in step order, each batch
    laid out and placed by the device feed. A callable source is never
    called past the last step."""
    if next_batch is not None:
        counter = iter(range(start, steps))
        pull = lambda: next_batch(next(counter))  # noqa: E731
    else:
        pull = lambda: next(batch_iter)           # noqa: E731
    return _prefetch.device_feed(pull, runner, depth=depth, workers=workers,
                                 name="train-feed")


def _per_step_loop(runner, state: TrainState, feed, next_batch, batch_iter, start: int,
                   steps: int, saver, prefix_base, save_participant, save_every: int,
                   async_save: bool, log_every: int, batch_size: Optional[int], on_metrics,
                   eval_every: int, eval_batch, eval_fn, on_eval,
                   sharded: Optional[bool]) -> TrainState:
    """One dispatch per step, fed synchronously or from ``feed``."""
    meter = None
    for step_i in range(start, steps):
        try:
            if feed is not None:
                batch = next(feed)
            elif next_batch is not None:
                batch = next_batch(step_i)
            else:
                batch = next(batch_iter)
        except StopIteration:
            _log.info("train: batch iterator exhausted at step %d", step_i)
            break
        if _faults.armed() and _faults.should_fire("nan_grads", step=step_i):
            # The fault harness: NaN floats through the real step.
            _log.warning("faults: injecting NaN batch at step %d", step_i)
            batch = _faults.corrupt_batch(batch)
        state, fetched = runner.run(state, batch)
        loss = fetched[0] if isinstance(fetched, tuple) else fetched
        if meter is None and log_every:
            meter = _make_meter(batch, batch_size, log_every, runner.plan.dp_size)
        if meter is not None:
            # The meter reads the loss back only at its period boundaries.
            rate = meter.step(sync=loss)
            if rate is not None:
                _log.info("train: step %d loss %.4f %.1f examples/s | q %d rb %.3fs",
                          step_i + 1, float(loss), rate,
                          feed.queue_depth() if feed is not None else 0,
                          meter.last_readback_s)
                if on_metrics is not None:
                    on_metrics(step_i + 1, float(loss), rate)
        if (eval_every and (step_i + 1) % eval_every == 0
                and not getattr(runner, "_is_remote_worker", False)):
            # An async worker process holds only a template of the state.
            val = runner.evaluate(state, eval_batch, eval_fn)
            if on_eval is not None:
                on_eval(step_i + 1, val)
        if (saver is not None and save_participant and save_every
                and (step_i + 1) % save_every == 0 and step_i + 1 < steps):
            saver.save(state, prefix_base, async_write=async_save, sharded=sharded)
    if meter is not None:
        meter.finish()
    return state


def _boundary_fn(steps: int, save_every: int, eval_every: int):
    """``next_boundary(i)``: the first step after ``i`` at which a block must
    end (a multiple of ``save_every`` or ``eval_every``, or ``steps``), the
    one clipping rule of the synchronous gather and the block feed
    (``autodist_tpu/training.py:566-579``)."""
    periods = [p for p in (save_every, eval_every) if p]

    def next_boundary(i: int) -> int:
        nxt = steps
        for p in periods:
            nxt = min(nxt, (i // p + 1) * p)
        return nxt

    return next_boundary


def _pull_block(next_batch, batch_iter, i: int, length: int):
    """Up to ``length`` batches from step ``i``; ``(batches, exhausted)``. A
    source that runs out mid-block still gives the batches it had: those
    steps were consumed and train."""
    blk = []
    for j in range(length):
        if next_batch is not None:
            blk.append(next_batch(i + j))
            continue
        try:
            blk.append(next(batch_iter))
        except StopIteration:
            _log.info("train: batch iterator exhausted at step %d", i + len(blk))
            return blk, True
    return blk, False


class _BlockFeed:
    """The fused loop's async block source (``autodist_tpu/training.py:582-643``):
    the device feed whose pulls gather the synchronous gather's
    cadence-clipped blocks and whose transform is ``runner.shard_block``, so
    block assembly and the copy to the card run ``depth`` blocks ahead."""

    def __init__(self, runner, next_batch, batch_iter, start: int, steps: int, unroll: int,
                 next_boundary, depth: int, workers: Optional[int] = None):
        self.first_batch = None   # the meter's sizing; set before the first emit
        self._next_batch, self._batch_iter = next_batch, batch_iter
        self._cursor, self._steps, self._unroll = start, steps, unroll
        self._next_boundary = next_boundary
        self._exhausted = False
        self._feed = _prefetch.device_feed(
            self._pull, runner, lambda blk, place: runner.shard_block(blk, place=place),
            depth=depth, workers=workers, name="train-feed")

    def _pull(self):
        i = self._cursor
        if self._exhausted or i >= self._steps:
            raise StopIteration
        blk, self._exhausted = _pull_block(self._next_batch, self._batch_iter, i,
                                           min(self._unroll, self._next_boundary(i) - i))
        if not blk:
            raise StopIteration
        if self.first_batch is None:
            self.first_batch = blk[0]
        self._cursor = i + len(blk)
        return blk

    def next_block(self) -> Optional[BatchBlock]:
        """The next placed block, or None at the end of the run."""
        try:
            return next(self._feed)
        except StopIteration:
            return None

    def queue_depth(self) -> int:
        return self._feed.queue_depth()

    def close(self):
        self._feed.close()


def _unrolled_loop(runner, state: TrainState, next_batch, batch_iter, start: int,
                   steps: int, unroll: int, saver, prefix_base, save_participant,
                   save_every: int, async_save: bool, log_every: int,
                   batch_size: Optional[int], on_metrics, eval_every: int, eval_batch,
                   eval_fn, on_eval, sharded: Optional[bool],
                   feed: Optional[_BlockFeed] = None) -> TrainState:
    """Blocks of up to ``unroll`` steps through ``runner.run_many``
    (``autodist_tpu/training.py:646-808``), ended at every save and eval
    cadence point and at ``steps``; the next block is gathered and placed
    while the device runs this one (``run_many`` returns once the block is
    enqueued), or comes from ``feed``. Losses are read back only when a
    metering period closes at a block's end."""
    next_boundary = _boundary_fn(steps, save_every if saver is not None else 0, eval_every)
    exhausted = False
    first_batch = None

    def gather(i: int) -> Optional[BatchBlock]:
        nonlocal exhausted, first_batch
        if feed is not None:
            block = feed.next_block()
            if first_batch is None:
                first_batch = feed.first_batch
            return block
        if exhausted or i >= steps:
            return None
        blk, exhausted = _pull_block(next_batch, batch_iter, i,
                                     min(unroll, next_boundary(i) - i))
        if not blk:
            return None
        if first_batch is None:
            first_batch = blk[0]
        return runner.shard_block(blk)

    meter = None
    step_i = start
    block = gather(step_i)
    while block is not None:
        state, fetched = runner.run_many(state, block)
        losses = fetched[0] if isinstance(fetched, tuple) else fetched
        step_i += block.length
        next_block = gather(step_i)
        queue_depth = (1 if next_block is not None else 0) \
            + (feed.queue_depth() if feed is not None else 0)
        if meter is None and log_every:
            meter = _make_meter(first_batch, batch_size, log_every, runner.plan.dp_size)
        if meter is not None:
            rate = meter.step_many(block.length, sync=losses)
            if rate is not None:
                last = float(losses[-1])
                _log.info("train: step %d loss %.4f %.1f examples/s | q %d rb %.3fs",
                          step_i, last, rate, queue_depth, meter.last_readback_s)
                if on_metrics is not None:
                    on_metrics(step_i, last, rate)
        if eval_every and step_i % eval_every == 0:
            val = runner.evaluate(state, eval_batch, eval_fn)
            if on_eval is not None:
                on_eval(step_i, val)
        if (saver is not None and save_participant and save_every
                and step_i % save_every == 0 and step_i < steps):
            saver.save(state, prefix_base, async_write=async_save, sharded=sharded)
        block = next_block
    if meter is not None:
        meter.finish()
    return state
