"""The input plane's device feed (the port's copy of ``autodist_tpu/data/prefetch.py:52-631``).

- :class:`BoundedQueue`: a bounded, closeable, thread-safe FIFO whose waits
  are all bounded.
- :class:`PrefetchProducer`: a bounded-depth background producer. Source
  pulls are serialized and ordered; the transform runs outside the source
  lock, so ``workers > 1`` parallelizes it while emission keeps the pull
  order. A source exception re-raises at the consuming ``next()``, in
  position; exhaustion ends iteration cleanly; ``close()`` is prompt.
- :func:`host_shard_rows`, :func:`host_shard` and
  :func:`assemble_global_batch`: per-host loading, where each process loads
  only its rows of the global batch.
- :func:`prefetch_to_device`: the producer composed with the runner's feed
  layout (``shard_batch``, or ``shard_block`` for blocks of ``unroll=K``
  batches), ``depth`` batches or blocks ahead of the step.

On a CUDA device the feed copies each batch from pinned host memory on a
side stream of its own; the consumer's stream waits on the copy's event and
every tensor is ``record_stream``-ed on it, so the caching allocator cannot
hand its memory out again while the step still reads it. A failure to pin
or to copy raises at the consuming step: the feed never falls back to a
synchronous pageable copy. On the CPU (the caller asked for it) there is no
pinning and no stream.
"""

import collections
import logging
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.runner import (BatchBlock, MicroBatched, ShardedBatch, _leaves,
                                       _tree_map)

__all__ = ["BoundedQueue", "QueueClosed", "EMPTY", "PrefetchProducer",
           "prefetch_to_device", "device_feed", "host_shard_rows", "host_shard",
           "assemble_global_batch", "default_prefetch_depth",
           "default_prefetch_workers"]

_log = logging.getLogger("autodist_tpu_torch")


class QueueClosed(RuntimeError):
    """Raised by :meth:`BoundedQueue.try_put` / an empty :meth:`BoundedQueue.get`
    after :meth:`BoundedQueue.close`, and by a consumer iterating a
    :class:`PrefetchProducer` that was closed under it."""


# get()'s "nothing there": distinct from any item (queues carry None).
EMPTY = object()


def default_prefetch_depth() -> int:
    """``AUTODIST_PREFETCH_DEPTH`` (0 = the synchronous feed)."""
    return max(0, const.env_int(const.PREFETCH_DEPTH, 0))


def default_prefetch_workers() -> int:
    """``AUTODIST_PREFETCH_WORKERS`` (>= 1)."""
    return max(1, const.env_int(const.PREFETCH_WORKERS, 1))


class BoundedQueue:
    """Bounded thread-safe FIFO with close semantics and bounded waits.

    - ``try_put`` never blocks: False when full, :class:`QueueClosed` once
      closed.
    - ``put`` blocks in bounded polls until there is room; False when the
      queue closes under it or ``timeout_s`` runs out.
    - ``get`` drains after close; an empty closed queue raises
      :class:`QueueClosed`.
    """

    POLL_S = 0.2   # per-wait bound; loops re-check closed/deadline

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"BoundedQueue capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._items: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def try_put(self, item) -> bool:
        with self._cond:
            if self._closed:
                raise QueueClosed("queue is closed")
            if len(self._items) >= self.capacity:
                return False
            self._items.append(item)
            self._cond.notify_all()
            return True

    def put(self, item, timeout_s: Optional[float] = None) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while True:
                if self._closed:
                    return False
                if len(self._items) < self.capacity:
                    self._items.append(item)
                    self._cond.notify_all()
                    return True
                wait = self.POLL_S
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def get(self, timeout_s: Optional[float] = None):
        """Next item; :data:`EMPTY` on timeout; :class:`QueueClosed` when
        the queue is closed and drained."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while True:
                if self._items:
                    item = self._items.popleft()
                    self._cond.notify_all()
                    return item
                if self._closed:
                    raise QueueClosed("queue is closed and drained")
                wait = self.POLL_S
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return EMPTY
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def close(self) -> List[Any]:
        """Close and drain: wakes every blocked putter and getter and
        returns the undelivered items. Idempotent."""
        with self._cond:
            self._closed = True
            drained = list(self._items)
            self._items.clear()
            self._cond.notify_all()
            return drained


class PrefetchProducer:
    """Bounded-depth background producer with ordered emission.

    ``pull()`` returns the next source item (called under one lock, strictly
    in order) or raises ``StopIteration``; ``transform`` runs outside that
    lock. Consumers iterate: items arrive in pull order, at most ``depth``
    buffered ahead; a producer-side exception re-raises at ``next()`` in its
    position (items pulled after it are dropped); exhaustion ends iteration;
    ``close()`` is prompt and idempotent, and iterating a closed producer
    raises :class:`QueueClosed`.

    Telemetry (``autodist_tpu/data/prefetch.py:228-236``): the
    ``data.producer_wait`` counter (seconds the producer spent pulling from
    the host source: the slow-loader signal), the ``data.producer_batches``
    counter and ``data.queue_depth`` gauge always; with spans on, a
    ``data.prefetch`` span per transformed item and its ``prefetch``
    memory-plane claim."""

    JOIN_S = 30.0
    NEXT_TIMEOUT_S = 86400.0  # a wedged producer must not park next() forever

    def __init__(self, pull: Callable[[], Any],
                 transform: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, workers: int = 1, name: str = "prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"prefetch workers must be >= 1, got {workers}")
        self._pull = pull
        self._transform = transform
        self._queue = BoundedQueue(depth)
        self._src_lock = threading.Lock()
        self._turn = threading.Condition()
        self._next_seq = 0        # next pull sequence (under _src_lock)
        self._next_emit = 0       # next sequence allowed to emit (under _turn)
        self._stop = threading.Event()
        self._src_done = False
        self._consumer_done = False
        self._name = name
        self._wait_c = telemetry.counter("data.producer_wait")
        self._batch_c = telemetry.counter("data.producer_batches")
        self._depth_g = telemetry.gauge("data.queue_depth")
        self._threads = [threading.Thread(target=self._work, daemon=True,
                                          name=f"{name}-{i}") for i in range(workers)]
        for t in self._threads:
            t.start()

    def _work(self):
        while not self._stop.is_set():
            kind, value = "item", None
            with self._src_lock:
                if self._src_done or self._stop.is_set():
                    return
                seq = self._next_seq
                self._next_seq += 1
                t0 = time.perf_counter()
                try:
                    value = self._pull()
                except StopIteration:
                    self._src_done = True
                    kind = "end"
                except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
                    self._src_done = True
                    kind, value = "error", e
                wait_s = time.perf_counter() - t0
            if kind == "item":
                self._wait_c.inc(wait_s)
                self._batch_c.inc()
            if kind == "item" and self._transform is not None:
                try:
                    with telemetry.span("data.prefetch", seq=seq):
                        value = self._transform(value)
                    if telemetry.enabled():
                        # The staged batch's census claim, a key a sequence
                        # (consumed claims prune as new ones arrive).
                        from autodist_tpu_torch.telemetry import memplane
                        memplane.tag("prefetch", value, key=f"{self._name}.{seq}")
                except BaseException as e:  # noqa: BLE001 - same contract
                    with self._src_lock:
                        self._src_done = True
                    kind, value = "error", e
            self._emit(seq, (kind, value))
            if kind != "item":
                return

    def _emit(self, seq: int, payload):
        """Wait (bounded) for this sequence's turn, push, advance the
        turnstile; the advance happens even when the push is skipped, so
        peers waiting on later turns never park."""
        with self._turn:
            while self._next_emit != seq and not self._stop.is_set():
                self._turn.wait(BoundedQueue.POLL_S)
        if not self._stop.is_set():
            self._queue.put(payload)
            self._depth_g.set(len(self._queue))
        with self._turn:
            self._next_emit = max(self._next_emit, seq + 1)
            self._turn.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        if self._consumer_done:
            raise StopIteration
        deadline = time.monotonic() + self.NEXT_TIMEOUT_S
        while True:
            try:
                item = self._queue.get(timeout_s=BoundedQueue.POLL_S)
            except QueueClosed:
                raise QueueClosed("prefetch producer is closed") from None
            if item is EMPTY:
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"prefetch consumer waited {self.NEXT_TIMEOUT_S:.0f}s "
                                       f"with no item, end marker or error")
                continue
            self._depth_g.set(len(self._queue))
            kind, value = item
            if kind == "item":
                return value
            self._consumer_done = True
            if kind == "end":
                raise StopIteration
            raise value

    def queue_depth(self) -> int:
        return len(self._queue)

    def close(self, timeout_s: Optional[float] = None):
        """Stop the workers and drop buffered items; the join is bounded."""
        self._stop.set()
        self._queue.close()
        with self._turn:
            self._turn.notify_all()
        deadline = time.monotonic() + (self.JOIN_S if timeout_s is None else timeout_s)
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self._stop.set()
            self._queue.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# ------------------------------------------------------------ per-host rows

def _modal_leading_dim(leaves, batch_rows: Optional[int] = None) -> Optional[int]:
    """The batch's row count: the most common leading dim; two equally
    common ones raise (``batch_rows=`` names it)."""
    if batch_rows is not None:
        return int(batch_rows)
    dims = collections.Counter(int(np.shape(leaf)[0]) for leaf in leaves
                               if np.ndim(leaf) >= 1)
    if not dims:
        return None
    top = max(dims.values())
    modal = [d for d, n in dims.items() if n == top]
    if len(modal) > 1:
        raise ValueError(f"ambiguous batch dim: leading dims {sorted(modal)} are equally "
                         f"common across the batch's leaves; pass batch_rows= to name "
                         f"the batch dimension explicitly")
    return modal[0]


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_rows(n_rows: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """The contiguous ``[start, stop)`` rows of an ``n_rows`` global batch
    that process ``process_id`` of ``num_processes`` loads (blocks in rank
    order, disjoint, covering every row once)."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of [0, {num_processes})")
    if n_rows % num_processes != 0:
        raise ValueError(f"global batch of {n_rows} rows does not tile over "
                         f"{num_processes} processes; make it divisible")
    per = n_rows // num_processes
    return process_id * per, (process_id + 1) * per


def host_shard(batch: Any, process_id: Optional[int] = None,
               num_processes: Optional[int] = None, batch_rows: Optional[int] = None) -> Any:
    """A global host batch cut to this process's row block; leaves whose
    leading dim is not the batch's pass through whole."""
    rank, world = _world()
    process_id = rank if process_id is None else process_id
    num_processes = world if num_processes is None else num_processes
    if num_processes == 1:
        return batch
    n_rows = _modal_leading_dim(_leaves(batch), batch_rows)
    if n_rows is None:
        return batch
    start, stop = host_shard_rows(n_rows, process_id, num_processes)
    return _tree_map(lambda leaf: leaf[start:stop]
                     if np.ndim(leaf) >= 1 and np.shape(leaf)[0] == n_rows else leaf, batch)


def assemble_global_batch(runner, local_batch: Any, process_id: Optional[int] = None,
                          num_processes: Optional[int] = None,
                          batch_rows: Optional[int] = None,
                          place: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """The device side of per-host loading: this process's local rows
    (``[B/num_processes, ...]`` per batch leaf) placed as its share of the
    global batch. It needs the runner's layout to hand this rank exactly
    that block (a data-major mesh whose ranks are the processes, no seq
    axis); any other layout raises with the rows it asks for. Leaves that
    are not the batch's replicate whole. Gradient accumulation's micro
    layout needs the global batch and raises."""
    if runner._accum > 1:
        raise ValueError("assemble_global_batch does not support accumulation_steps > 1 "
                         "(the micro-batch [k, B/k] reshape needs the global batch); "
                         "feed global batches through shard_batch instead")
    rank, world = _world()
    process_id = rank if process_id is None else process_id
    num_processes = world if num_processes is None else num_processes
    place = place or runner.place
    local_rows = _modal_leading_dim(_leaves(local_batch), batch_rows)

    def put(leaf):
        t = torch.as_tensor(leaf)
        if local_rows is not None and t.dim() >= 1 and t.shape[0] == local_rows:
            global_n = local_rows * num_processes
            if global_n % runner.plan.dp_size:
                raise ValueError(f"global batch of {global_n} rows ({local_rows} local x "
                                 f"{num_processes} processes) does not split over the "
                                 f"mesh's data extent (dp={runner.plan.dp_size})")
            want = runner.plan.batch_rows(global_n, runner._data_index)
            off = process_id * local_rows
            if (want.start, want.stop) != (off, off + local_rows):
                raise ValueError(f"feed layout asks process {process_id} for rows "
                                 f"[{want.start}, {want.stop}) outside its local block "
                                 f"[{off}, {off + local_rows}); feed global batches instead")
        return place(t)

    out = _tree_map(put, local_batch)
    if not isinstance(out, dict):
        return out
    out = ShardedBatch(out)
    out.rows = {local_rows: 1} if local_rows is not None else {}
    return out


# --------------------------------------------------------------- device feed

class _Staged:
    """A batch copied on the feed's side stream, and the copy's event."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch, self.event = batch, event


def _tensors(tree):
    if isinstance(tree, BatchBlock):
        tree = tree.tree
    for leaf in _leaves(tree):
        leaf = leaf.value if isinstance(leaf, MicroBatched) else leaf
        if isinstance(leaf, torch.Tensor):
            yield leaf


class _DeviceFeed(PrefetchProducer):
    """A producer of staged batches whose ``next()`` hands them to the
    consumer's current stream: the stream waits for the copy, and every
    tensor is recorded on it for the caching allocator."""

    def __init__(self, *args, device: torch.device, **kwargs):
        self._device = device
        super().__init__(*args, **kwargs)

    def __next__(self):
        staged = super().__next__()
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(staged.event)
        for t in _tensors(staged.batch):
            if t.is_cuda:
                t.record_stream(stream)
        return staged.batch


def device_feed(pull: Callable[[], Any], runner, shard: Optional[Callable] = None,
                depth: int = 2, workers: Optional[int] = None,
                name: str = "device-prefetch") -> PrefetchProducer:
    """A producer over ``pull`` whose transform lays each batch out for
    ``runner`` (``shard(batch, place)``, default ``runner.shard_batch``) and
    places it on the runner's device: on a CUDA device from pinned memory on
    a side stream (see the module docstring), on the CPU as it is."""
    if shard is None:
        shard = lambda batch, place: runner.shard_batch(batch, place=place)  # noqa: E731
    workers = workers or default_prefetch_workers()
    depth = max(1, int(depth))
    device = runner.device
    if device.type != "cuda":
        return PrefetchProducer(pull, lambda batch: shard(batch, runner.place),
                                depth=depth, workers=workers, name=name)
    stream = torch.cuda.Stream(device)

    def pinned_copy(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            return t.to(device, non_blocking=True)
        return t.pin_memory().to(device, non_blocking=True)

    def stage(batch):
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = shard(batch, pinned_copy)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(out, event)

    return _DeviceFeed(pull, stage, depth=depth, workers=workers, name=name, device=device)


def _as_pull(source) -> Callable[[], Any]:
    """A loader, iterable or iterator, or a 0-argument callable, as a pull."""
    if callable(source) and not hasattr(source, "__iter__") \
            and not hasattr(source, "__next__"):
        return source
    it = iter(source)
    return lambda: next(it)


def prefetch_to_device(source, runner, depth: int = 2, unroll: int = 1,
                       workers: Optional[int] = None, per_host: bool = False,
                       process_id: Optional[int] = None,
                       num_processes: Optional[int] = None,
                       name: str = "device-prefetch") -> PrefetchProducer:
    """The async device feed: ``runner.shard_batch`` (or, with
    ``per_host=True``, :func:`assemble_global_batch` over a source of this
    process's local rows) applied ``depth`` batches ahead of the step, so
    host loading and the copy to the card overlap the running step
    (``autodist_tpu/data/prefetch.py:568-625``).

    With ``unroll=K`` each item is a :class:`~autodist_tpu_torch.runner.BatchBlock`
    of K consecutive batches (``runner.shard_block``) for ``run_many``;
    ``depth`` then counts blocks. A source that runs out mid-block yields
    nothing for the partial block: the remainder is dropped, logged, and
    iteration ends. ``per_host`` takes ``unroll=1`` only."""
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    src = _as_pull(source)
    if per_host:
        if unroll > 1:
            raise ValueError("per_host prefetch supports unroll=1 only (blocks stack the "
                             "global batch)")
        shard = lambda batch, place: assemble_global_batch(  # noqa: E731
            runner, batch, process_id=process_id, num_processes=num_processes, place=place)
        return device_feed(src, runner, shard, depth=depth, workers=workers, name=name)
    if unroll > 1:
        done = [False]

        def pull_block():
            if done[0]:
                raise StopIteration
            blk = []
            for _ in range(unroll):
                try:
                    blk.append(src())
                except StopIteration:
                    done[0] = True
                    if blk:
                        _log.info("prefetch: source exhausted mid-block; dropping the "
                                  "%d-batch remainder (unroll=%d)", len(blk), unroll)
                    raise StopIteration from None
            return blk

        return device_feed(pull_block, runner,
                           lambda blk, place: runner.shard_block(blk, place=place),
                           depth=depth, workers=workers, name=name)
    return device_feed(src, runner, depth=depth, workers=workers, name=name)
