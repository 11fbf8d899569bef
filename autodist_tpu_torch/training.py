"""Training loop with automatic checkpoint and resume (the port's copy of
``train`` in ``autodist_tpu/training.py:76-808``): periodic chief-gated saves
under the JAX package's names, resume from the latest checkpoint, throughput
metering, evaluation cadence, the prefetching device feed, a final save, so
a run restarted with the same command continues where it stopped; and the
fused loop of ``unroll=K`` (``_unrolled_loop``), which runs blocks of K
steps through ``runner.run_many`` (one CUDA graph replay a block on the
card) while the host gathers the next block.

The telemetry planes hook in at the JAX package's sites: the
``train.data_wait``, ``train.dispatch``, ``train.eval`` and
``train.checkpoint`` spans; at each log boundary the attribution period
(``train.attr.*``, ``train.mfu``), ``train.steps_per_s``, the memory plane's
census tags, ``sample_device_memory``, ``emit_metrics``, the health monitor
(``health_monitor=`` or ``AUTODIST_HEALTH``) and the metric history's sample
(whose alert engine may halt the run); the final flush and the profile
write. Under ``AUTODIST_HEALTH_ACTION=recover`` (or the alert engine's
``recover``) a ring of deep-copied last-known-good states taken at healthy
log boundaries is the rollback target of an anomaly.
"""

import copy
import logging
import os
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.data import prefetch as _prefetch
from autodist_tpu_torch.parallel import recovery as _recovery
from autodist_tpu_torch.runner import BatchBlock, MicroBatched, ShardedBatch, TrainState, _leaves
from autodist_tpu_torch.telemetry import health as _health
from autodist_tpu_torch.telemetry import history as _history
from autodist_tpu_torch.telemetry import memplane as _memplane
from autodist_tpu_torch.telemetry import openmetrics as _openmetrics
from autodist_tpu_torch.telemetry import profiling as _profiling
from autodist_tpu_torch.testing import faults as _faults
from autodist_tpu_torch.utils.metrics import ThroughputMeter

_log = logging.getLogger("autodist_tpu_torch")


def _observe_health(monitor, runner, step: int, losses, state: TrainState):
    """Feed the health monitor at a log boundary, where the loss readback
    already synced: ``losses`` are the period's per-step losses (device
    tensors, read here), the bundle the runner's latest (one read of four
    floats). Raises :class:`telemetry.HealthRecover` under
    ``AUTODIST_HEALTH_ACTION=recover`` (``train()`` rolls back) or
    :class:`telemetry.HealthHalt` under ``halt``, with the live state."""
    bundle = getattr(runner, "last_health", None)
    if bundle is not None:
        bundle = bundle.detach().cpu().numpy()
    flat = torch.cat([torch.as_tensor(l).detach().reshape(-1).float() for l in losses]
                     ).cpu().numpy() if losses else np.zeros(0, np.float32)
    anomalies = monitor.observe(step, flat, bundle)
    if anomalies and monitor.should_recover:
        raise _health.HealthRecover(step, state, anomalies)
    if anomalies and monitor.should_halt:
        raise _health.HealthHalt(step, state, anomalies)


def _copy_state(state: TrainState) -> TrainState:
    """A deep copy of ``state`` on its device (parameters, the optimizer and
    its state, the codecs' state), sharing only the layout: the runner
    updates its state in place, so a ring entry must own its tensors."""
    return copy.deepcopy(state, memo={id(state.layout): state.layout})


def _boundary(runner, state: TrainState, step: int, rate: float, meter, monitor,
              pending_losses, ring) -> None:
    """The log boundary's planes, in the JAX package's order
    (``autodist_tpu/training.py:458-520``): the steps/s gauge, the memory
    census and samples, the metrics rows, the health monitor, the history
    sample (an alert halt propagates with the live state), and, the boundary
    having closed healthy, the recover ring's snapshot."""
    telemetry.gauge("train.steps_per_s").set(round(rate / meter.batch_size, 4))
    if telemetry.enabled():
        _memplane.tag("params", state.params)
        _memplane.tag("opt_state", state.optimizer)
        telemetry.sample_device_memory(opt_state=state.optimizer)
        telemetry.emit_metrics(global_step=step)
    if monitor is not None:
        _observe_health(monitor, runner, step, pending_losses, state)
        pending_losses.clear()
    try:
        _history.maybe_sample(step)
    except telemetry.AlertHalt as e:
        e.state = state
        raise
    if ring is not None:
        ring.push(step, state)
        if telemetry.enabled():
            _memplane.tag("snapshots", ring.states())


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
    ``run_many`` cannot capture raises its ``RuntimeError``.

    ``health_monitor`` overrides the ``AUTODIST_HEALTH`` default (a
    :class:`telemetry.HealthMonitor`): it consumes each log period's
    per-step losses and the runner's health bundle at the boundary where the
    loss readback already syncs, and its anomalies follow
    ``AUTODIST_HEALTH_ACTION`` (``halt`` raises :class:`telemetry.HealthHalt`
    with the live state). Monitoring needs ``log_every > 0``. Under
    ``AUTODIST_HEALTH_ACTION=recover`` (or ``AUTODIST_ALERT_ACTION=recover``)
    an anomaly rolls back to the newest deep-copied state of a healthy
    boundary and resumes (replaying the rolled-back steps exactly with a
    callable ``batches``), at most ``AUTODIST_RECOVER_MAX`` attempts an
    incident before escalating to the halt."""
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
    # AUTODIST_METRICS_PORT serves /metrics and /healthz from the trainer too.
    _openmetrics.maybe_serve()
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

    monitor = health_monitor if health_monitor is not None \
        else _health.HealthMonitor.from_env()
    if monitor is not None and not log_every:
        _log.warning("train: health monitors need log_every > 0 (the bundle readback "
                     "rides log boundaries); disabling them for this run")
        monitor = None
    if unroll > 1 and not getattr(runner, "supports_run_many", True):
        _log.warning("train: unroll=%d requested but %s has no fused multi-step path (async "
                     "regime); falling back to per-step dispatch", unroll, type(runner).__name__)
        unroll = 1
    recover_armed = ((monitor is not None and monitor.config.action == "recover")
                     or str(const.ENV.AUTODIST_ALERT_ACTION.val) == "recover")
    ring = _recovery.SnapshotRing(copy_fn=_copy_state) if recover_armed else None
    if ring is not None and batch_iter is not None:
        _log.warning("train: recover action with an ITERABLE batch source: a rollback cannot "
                     "replay consumed batches, so the resumed loop continues on the next "
                     "unconsumed ones (pass a callable batches(step) for exact replay)")

    def run_attempt(attempt_state: TrainState) -> TrainState:
        """One pass of the loop from ``attempt_state``'s own step; the feeds
        are built per attempt, so a rollback's replay pulls the rolled-back
        steps."""
        start_i = attempt_state.step
        feed = None
        try:
            if unroll > 1:
                next_boundary = _boundary_fn(steps, save_every if saver is not None else 0,
                                             eval_every)
                if prefetch_depth > 0:
                    feed = _BlockFeed(runner, next_batch, batch_iter, start_i, steps, unroll,
                                      next_boundary, prefetch_depth)
                return _unrolled_loop(runner, attempt_state, next_batch, batch_iter, start_i,
                                      steps, unroll, saver, prefix_base, save_participant,
                                      save_every, async_save, log_every, batch_size,
                                      on_metrics, eval_every, eval_batch, eval_fn, on_eval,
                                      sharded, feed, monitor, ring)
            if prefetch_depth > 0:
                feed = _step_feed(runner, next_batch, batch_iter, start_i, steps,
                                  prefetch_depth)
            return _per_step_loop(runner, attempt_state, feed, next_batch, batch_iter, start_i,
                                  steps, saver, prefix_base, save_participant, save_every,
                                  async_save, log_every, batch_size, on_metrics, eval_every,
                                  eval_batch, eval_fn, on_eval, sharded, monitor, ring)
        finally:
            if feed is not None:
                feed.close()

    attempt = 0
    last_fail_step = None
    while True:
        try:
            state = run_attempt(state)
            break
        except (_health.HealthRecover, telemetry.AlertRecover) as e:
            # The attempt budget is per incident: an anomaly at a later step
            # than the last means the earlier one was overcome, so it resets
            # (``autodist_tpu/training.py:355-385``).
            fail_step = getattr(e, "step", None)
            if fail_step is not None and last_fail_step is not None \
                    and fail_step > last_fail_step:
                attempt = 0
            if fail_step is not None:
                last_fail_step = fail_step
            attempt += 1
            state = _recovery.rollback(e, ring, attempt, _recovery.recover_max(),
                                       runner=runner)
    # The end-of-run attribution period and history sample come before the
    # final save, whose seconds would otherwise land in the tail period.
    if _profiling.active():
        _profiling.observe_period(state.step, require_steps=True)
    try:
        _history.maybe_sample(state.step, reason="final", force=True)
    except telemetry.AlertHalt as e:
        e.state = state
        raise
    # The final save stays synchronous: returning means the state is on disk.
    if saver is not None and save_participant and state.step > start:
        with telemetry.span("train.checkpoint", final=True):
            saver.save(state, prefix_base, sharded=sharded)
    if saver is not None:
        saver.wait()
    _profiling.maybe_write_profile()
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
                   sharded: Optional[bool], monitor=None, ring=None) -> TrainState:
    """One dispatch per step, fed synchronously or from ``feed``. With a
    health monitor the per-step losses stay on the device until the
    boundary reads them together."""
    meter = None
    pending_losses = []
    for step_i in range(start, steps):
        try:
            with telemetry.span("train.data_wait"):
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
        with telemetry.span("train.dispatch"):
            state, fetched = runner.run(state, batch)
        loss = fetched[0] if isinstance(fetched, tuple) else fetched
        if monitor is not None:
            pending_losses.append(loss)
        if meter is None and log_every:
            meter = _make_meter(batch, batch_size, log_every, runner.plan.dp_size)
        if meter is not None:
            # The meter reads the loss back only at its period boundaries.
            rate = meter.step(sync=loss)
            if rate is not None:
                attr = _profiling.observe_period(step_i + 1) if _profiling.active() else None
                stats = getattr(runner, "wire_stats", None)
                stats = stats() if callable(stats) else None
                _log.info("train: step %d loss %.4f %.1f examples/s | q %d rb %.3fs%s%s",
                          step_i + 1, float(loss), rate,
                          feed.queue_depth() if feed is not None else 0,
                          meter.last_readback_s,
                          f" | {stats.format_line()}" if stats else "",
                          _profiling.format_attr_line(attr))
                _boundary(runner, state, step_i + 1, rate, meter, monitor, pending_losses,
                          ring)
                if on_metrics is not None:
                    on_metrics(step_i + 1, float(loss), rate)
        if (eval_every and (step_i + 1) % eval_every == 0
                and not getattr(runner, "_is_remote_worker", False)):
            # An async worker process holds only a template of the state.
            with telemetry.span("train.eval"):
                val = runner.evaluate(state, eval_batch, eval_fn)
            if on_eval is not None:
                on_eval(step_i + 1, val)
        if (saver is not None and save_participant and save_every
                and (step_i + 1) % save_every == 0 and step_i + 1 < steps):
            with telemetry.span("train.checkpoint"):
                saver.save(state, prefix_base, async_write=async_save, sharded=sharded)
    if monitor is not None and pending_losses:
        # A NaN in the final partial period still reaches the monitor.
        _observe_health(monitor, runner, state.step, pending_losses, state)
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
                   feed: Optional[_BlockFeed] = None, monitor=None, ring=None) -> TrainState:
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
            with telemetry.span("train.data_wait"):
                block = feed.next_block()
            if first_batch is None:
                first_batch = feed.first_batch
            return block
        if exhausted or i >= steps:
            return None
        with telemetry.span("train.data_wait"):
            blk, exhausted = _pull_block(next_batch, batch_iter, i,
                                         min(unroll, next_boundary(i) - i))
        if not blk:
            return None
        if first_batch is None:
            first_batch = blk[0]
        with telemetry.span("runner.shard_block"):
            return runner.shard_block(blk)

    meter = None
    step_i = start
    # The period's per-block loss stacks, read at the boundary with the
    # block-reduced health bundle.
    pending_losses = []
    block = gather(step_i)
    while block is not None:
        with telemetry.span("train.dispatch", steps=block.length):
            state, fetched = runner.run_many(state, block)
        losses = fetched[0] if isinstance(fetched, tuple) else fetched
        if monitor is not None:
            pending_losses.append(losses)
        step_i += block.length
        next_block = gather(step_i)
        queue_depth = (1 if next_block is not None else 0) \
            + (feed.queue_depth() if feed is not None else 0)
        if telemetry.enabled():
            telemetry.gauge("train.dispatch_queue_depth").set(queue_depth)
        if meter is None and log_every:
            meter = _make_meter(first_batch, batch_size, log_every, runner.plan.dp_size)
        if meter is not None:
            rate = meter.step_many(block.length, sync=losses)
            if rate is not None:
                attr = _profiling.observe_period(step_i) if _profiling.active() else None
                last = float(losses[-1])
                _log.info("train: step %d loss %.4f %.1f examples/s | q %d rb %.3fs%s",
                          step_i, last, rate, queue_depth, meter.last_readback_s,
                          _profiling.format_attr_line(attr))
                _boundary(runner, state, step_i, rate, meter, monitor, pending_losses, ring)
                if on_metrics is not None:
                    on_metrics(step_i, last, rate)
        if eval_every and step_i % eval_every == 0:
            with telemetry.span("train.eval"):
                val = runner.evaluate(state, eval_batch, eval_fn)
            if on_eval is not None:
                on_eval(step_i, val)
        if (saver is not None and save_participant and save_every
                and step_i % save_every == 0 and step_i < steps):
            with telemetry.span("train.checkpoint"):
                saver.save(state, prefix_base, async_write=async_save, sharded=sharded)
        block = next_block
    if monitor is not None and pending_losses:
        _observe_health(monitor, runner, step_i, pending_losses, state)
    if meter is not None:
        meter.finish()
    return state
