"""Training loop with automatic checkpoint and resume (the port's copy of
``train`` in ``autodist_tpu/training.py:76-565``): periodic chief-gated saves
under the JAX package's names, resume from the latest checkpoint, throughput
metering, evaluation cadence, the prefetching device feed, and a final save,
so a run restarted with the same command continues where it stopped.

Not ported yet, and each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: ``unroll > 1`` (``run_many``), ``health_monitor``,
the recover ring, and the planes the environment can arm
(``const.UNPORTED_PLANES``).
"""

import logging
import os
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.checkpoint.saver import Saver
from autodist_tpu_torch.data import prefetch as _prefetch
from autodist_tpu_torch.runner import MicroBatched, ShardedBatch, TrainState, _leaves
from autodist_tpu_torch.utils.metrics import ThroughputMeter

_log = logging.getLogger("autodist_tpu_torch")

PLANES_ROADMAP = "ROADMAP.md, Queue 1: train()'s health, recover, profiling, history and " \
                 "openmetrics hooks"


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


def _refuse_unported(unroll: Optional[int], health_monitor) -> None:
    if unroll is not None and unroll > 1:
        raise NotImplementedError(_prefetch.UNROLL_ROADMAP)
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
    some tensor is sharded across ranks). Returns the final state."""
    _refuse_unported(unroll, health_monitor)
    if prefetch_depth is None:
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

    feed = _step_feed(runner, next_batch, batch_iter, start, steps, prefetch_depth) \
        if prefetch_depth > 0 else None
    try:
        state = _per_step_loop(runner, state, feed, next_batch, batch_iter, start, steps,
                               saver, prefix_base, save_participant, save_every, async_save,
                               log_every, batch_size, on_metrics, eval_every, eval_batch,
                               eval_fn, on_eval, sharded)
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
        if eval_every and (step_i + 1) % eval_every == 0:
            val = runner.evaluate(state, eval_batch, eval_fn)
            if on_eval is not None:
                on_eval(step_i + 1, val)
        if (saver is not None and save_participant and save_every
                and (step_i + 1) % save_every == 0 and step_i + 1 < steps):
            saver.save(state, prefix_base, async_write=async_save, sharded=sharded)
    if meter is not None:
        meter.finish()
    return state
