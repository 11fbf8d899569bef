"""Request queue + continuous/dynamic batcher — the serving plane's host core
(the port's copy of ``autodist_tpu/serving/batcher.py``, on the port's
``data/prefetch.py``, ``telemetry``, ``reqtrace`` and ``testing/sanitizer``).

The reference's serving story ended at SavedModel export; this module is the
missing online half: incoming requests are packed into padded device batches
and driven to completion by ONE background thread per batcher (the device is
a serial resource; a thread per request would just contend for it). Two
batching disciplines share the loop:

- ``continuous`` (default) — admission at decode-step granularity: whenever a
  slot is free and a request is waiting, the request is prefilled into the
  slot *between* decode steps, and a request that finishes early (hit its
  token budget or the EOS id) leaves the batch immediately, freeing its
  KV-cache slot for the next waiter. Short generations never wait for long
  ones (no convoy effect).
- ``static`` — classic wave batching: admit a full batch only when the
  previous wave has drained. Simpler, worse tail latency under mixed
  generation lengths; kept as the baseline continuous batching is measured
  against.

Prompts are padded to BUCKETED lengths (powers of two by default) so the jit
cache holds one prefill program per bucket, not one per prompt length.

This module is deliberately torch-free: the device work hides behind the
small engine interface (:mod:`autodist_tpu_torch.serving.runtime` implements
it; tests drive the loop with a fake), so packing/bucketing/slot-reuse logic
is unit-testable without a model. Grad mode is per thread, so the engines
enter ``torch.no_grad`` in each call themselves: the scheduler thread would
otherwise record an autograd graph over the params every decode step.

SLO metrics ride the process-global :mod:`autodist_tpu_torch.telemetry` registry
(always on — they are the service's product, a few dict operations per
request): ``serve.latency_s.{queue,prefill,decode,total}`` histograms with
ms-scale buckets (``metrics.BUCKET_FAMILIES``), ``serve.queue_depth`` /
``serve.batch_fill`` gauges, ``serve.requests.{submitted,completed,rejected}``
counters. Host spans (``serve.prefill``, ``serve.decode_step``) appear in the
cluster trace when telemetry is enabled.
"""

import dataclasses
import inspect
import itertools
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch import telemetry
# The admission queue is the input-data plane's staging core (BoundedQueue:
# bounded, closeable, bounded waits) — ONE queue implementation behind the
# prefetch producers and the serving batchers.
from autodist_tpu_torch.data.prefetch import EMPTY, BoundedQueue, QueueClosed
from autodist_tpu_torch.telemetry import reqtrace as _reqtrace
from autodist_tpu_torch.testing.sanitizer import san_lock, san_event

# Request-phase attribution vocabulary (the serving twin of
# profiling.ATTR_PHASES): per-round share gauges serve.attr.<phase>, shares
# summing to 1.0 over the completions the round observed.
ATTR_PHASES = ("wire", "queue", "prefill", "decode")


class ServeError(RuntimeError):
    """A rejected or failed serving request (invalid shape, queue full,
    server-side failure) — shipped to remote clients as an error reply."""


class ServeBusy(ServeError):
    """Typed overload rejection: the admission queue (or the paged-KV pool
    behind it) is full RIGHT NOW, but the request itself is valid — retry
    later, or on another replica. The fleet router keys its shed-vs-fail
    decision on this type: a ``ServeBusy`` from one replica cascades to the
    next; any other ``ServeError`` is deterministic and is surfaced to the
    client unchanged."""


def default_buckets(max_len: int, floor: int = 8) -> Tuple[int, ...]:
    """Power-of-two prompt pad lengths up to ``max_len`` (inclusive as the
    last bucket even when max_len is not a power of two) — one jitted prefill
    program per bucket instead of one per prompt length."""
    out: List[int] = []
    b = floor
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``length``; raises :class:`ServeError` when the
    prompt exceeds every bucket (the request can never fit the cache)."""
    for b in buckets:
        if length <= b:
            return b
    raise ServeError(f"prompt length {length} exceeds the largest pad "
                     f"bucket {max(buckets)}")


def pad_prompt(prompt: np.ndarray, bucket: int) -> np.ndarray:
    """``[P] -> [1, bucket]`` right-padded with zeros. Right padding keeps
    positions [0, P) real; the pad tail's K/V is masked until decode steps
    overwrite it position by position (see runtime.LMEngine)."""
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(prompt)] = prompt
    return out


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (defaults from the ``AUTODIST_SERVE_*`` flags via
    :meth:`from_env`). ``buckets=()`` lets the engine derive power-of-two pad
    lengths from the model's ``max_len``. Sampling statics (temperature/
    top_k/top_p) are per-server, not per-request — a per-request temperature
    would be one compiled decode program per value."""

    max_batch: int = 8          # decode slot capacity (AUTODIST_SERVE_MAX_BATCH)
    mode: str = "continuous"    # or "static" (AUTODIST_SERVE_MODE)
    max_queue: int = 256        # admission bound (AUTODIST_SERVE_QUEUE)
    request_timeout_s: float = 120.0  # completion-wait cap (AUTODIST_SERVE_TIMEOUT_S)
    buckets: Tuple[int, ...] = ()     # prompt pad lengths; () = engine default
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = -1            # generation stops at this token id; -1 disables
    # Paged-KV knobs (serving/paged.py): page length in tokens (0 = the
    # dense per-slot slab), pool size in pages (0 = derived at HBM parity
    # with the dense slab), and the shared-prefix page cache toggle.
    page_len: int = 0           # AUTODIST_KV_PAGE_LEN; 0 = dense slab
    kv_pages: int = 0           # pool pages incl. scratch; 0 = derived
    prefix_cache: bool = True   # AUTODIST_PREFIX_CACHE

    def __post_init__(self):
        if self.mode not in ("continuous", "static"):
            raise ValueError(f"unknown serving mode {self.mode!r}; valid: "
                             f"'continuous', 'static'")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.buckets and list(self.buckets) != sorted(self.buckets):
            raise ValueError("buckets must be ascending")
        if self.page_len < 0 or self.kv_pages < 0:
            raise ValueError("page_len/kv_pages must be >= 0")

    @staticmethod
    def from_env(**overrides) -> "ServeConfig":
        from autodist_tpu_torch import const
        base = dict(max_batch=const.ENV.AUTODIST_SERVE_MAX_BATCH.val,
                    mode=const.ENV.AUTODIST_SERVE_MODE.val,
                    max_queue=const.ENV.AUTODIST_SERVE_QUEUE.val,
                    request_timeout_s=const.ENV.AUTODIST_SERVE_TIMEOUT_S.val,
                    page_len=const.ENV.AUTODIST_KV_PAGE_LEN.val,
                    prefix_cache=const.ENV.AUTODIST_PREFIX_CACHE.val)
        base.update(overrides)
        return ServeConfig(**base)


class ServeRequest:
    """One in-flight request: payload + completion event + timing stamps.

    ``done`` is set exactly once, after ``tokens``/``output``/``error`` and
    the timing stamps are final — the transport handler thread waits on it
    (bounded) and reads the result without further locking.

    ``abandoned``/``deadline`` are the dead-request plane: the transport
    marks a request abandoned when its client's wait times out, and the
    batcher stamps a server-side deadline at submission — either way the
    scheduler drops the request at its next decision point (admission pop,
    or the decode round for an in-flight slot) instead of burning capacity
    on output nobody will read."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "seed", "keys",
                 "t_submit", "t_admit", "t_prefill_done", "t_done",
                 "done", "tokens", "output", "error", "slot",
                 "abandoned", "deadline", "rid_token", "wire_s")

    def __init__(self, rid: int, prompt, max_new_tokens: int = 0,
                 seed: int = 0, rid_token: Optional[str] = None,
                 wire_s: float = 0.0):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        # Fleet-scope identity: the router's rid token (when one rode the
        # wire) is what joins this request's records across processes; the
        # local rid stays the slot-table/dedup key. wire_s is the
        # trace-context decomposition the transport computed at receive
        # (origin send stamp + per-connection clock offset).
        self.rid_token = rid_token
        self.wire_s = wire_s
        self.keys = None                  # per-step sampling seeds [max_new]
        self.t_submit = time.perf_counter()
        self.t_admit = 0.0
        self.t_prefill_done = 0.0
        self.t_done = 0.0
        self.done = san_event()
        self.tokens: List[int] = []       # generated ids (LM path)
        self.output = None                # model output (apply path)
        self.error: Optional[str] = None
        self.slot = -1
        self.abandoned = False            # client gave up; drop, don't decode
        self.deadline = 0.0               # t_submit + request_timeout_s

    @property
    def trace_key(self):
        """The request-trace join key: the fleet rid token when one exists,
        else the local rid (direct clients trace per process only)."""
        return self.rid_token if self.rid_token is not None else self.rid

    def abandon(self):
        """Mark the request not worth finishing (its client stopped
        waiting). A plain flag, no lock: the scheduler reads it at the next
        decision point and dropping one round late is harmless."""
        self.abandoned = True

    def dead(self, now: float) -> bool:
        return self.abandoned or (self.deadline and now > self.deadline)

    def timing(self) -> dict:
        """Wire-encodable latency breakdown (seconds) plus the server-side
        correlation id, shipped in the reply — ``request_id`` is what ties a
        client-observed latency to the server's spans (``serve.prefill``/
        ``serve.decode_step`` carry the same id in their args) and to the
        ``status`` opcode's in-flight table (``tools/adtop.py``)."""
        return {"request_id": self.rid,
                "queue_s": round(self.t_admit - self.t_submit, 6),
                "prefill_s": round(self.t_prefill_done - self.t_admit, 6),
                "decode_s": round(self.t_done - self.t_prefill_done, 6),
                "total_s": round(self.t_done - self.t_submit, 6)}

    def finish(self, error: Optional[str] = None):
        self.stamp_done(error)
        self.done.set()

    def stamp_done(self, error: Optional[str] = None):
        """Set the completion timestamps WITHOUT signalling the waiter —
        the batcher books its SLO counters between stamping and the
        ``done.set()``, so a client whose reply arrived can never read a
        ``stats``/``status`` snapshot that misses its own request."""
        self.t_done = time.perf_counter()
        if not self.t_admit:          # rejected/failed before admission
            self.t_admit = self.t_prefill_done = self.t_done
        if not self.t_prefill_done:
            self.t_prefill_done = self.t_done
        self.error = error


class _ServeMetrics:
    """Cached instrument handles for the serve.* SLO families (get-or-create
    once, not per request)."""

    def __init__(self):
        reg = telemetry.registry()
        self.lat = {f: reg.histogram(f"serve.latency_s.{f}")
                    for f in ("queue", "prefill", "decode", "total")}
        self.depth = reg.gauge("serve.queue_depth")
        self.fill = reg.gauge("serve.batch_fill")
        self.submitted = reg.counter("serve.requests.submitted")
        self.completed = reg.counter("serve.requests.completed")
        self.rejected = reg.counter("serve.requests.rejected")
        # Per-phase attribution (the serving twin of train.attr.*): shares
        # of completed requests' wall time summing to 1.0, recomputed each
        # scheduler round from the completions since the last flush.
        self.attr = {p: reg.gauge(f"serve.attr.{p}") for p in ATTR_PHASES}
        self._attr_acc = {p: 0.0 for p in ATTR_PHASES}
        self._attr_lock = san_lock()

    def observe(self, req: ServeRequest):
        t = req.timing()
        self.lat["queue"].observe(t["queue_s"])
        self.lat["prefill"].observe(t["prefill_s"])
        self.lat["decode"].observe(t["decode_s"])
        # The total histogram carries the slowest-in-window EXEMPLAR: rid +
        # phase breakdown, so a firing serve_p99_burn names a concrete
        # traceable request instead of a quantile.
        self.lat["total"].observe(t["total_s"], exemplar={
            "rid": str(req.trace_key), "wire_s": round(req.wire_s, 6),
            "queue_s": t["queue_s"], "prefill_s": t["prefill_s"],
            "decode_s": t["decode_s"], "total_s": t["total_s"]})
        with self._attr_lock:
            self._attr_acc["wire"] += max(0.0, req.wire_s)
            self._attr_acc["queue"] += max(0.0, t["queue_s"])
            self._attr_acc["prefill"] += max(0.0, t["prefill_s"])
            self._attr_acc["decode"] += max(0.0, t["decode_s"])

    def flush_attr(self):
        """Fold the completions observed since the last flush into the
        serve.attr.* share gauges (called once per scheduler round; a round
        with no completions keeps the previous shares — gauges that flap to
        zero between requests would be unreadable on a console)."""
        with self._attr_lock:
            parts = dict(self._attr_acc)
            total = sum(parts.values())
            if total <= 0.0:
                return
            for p in ATTR_PHASES:
                self._attr_acc[p] = 0.0
        for p in ATTR_PHASES:
            self.attr[p].set(round(parts[p] / total, 4))


class _BatcherBase:
    """Shared queue/loop/lifecycle machinery for the two batchers: bounded
    admission queue, ONE daemon scheduling thread, dead-request dropping,
    drain-and-fail shutdown. Subclasses own :meth:`run_once` (the actual
    scheduling policy) and their ``submit`` validation."""

    kind = ""
    # Bounded idle wait between queue polls when no slot is active
    # (package waits are always bounded).
    IDLE_WAIT_S = 0.02

    def __init__(self, engine, config: ServeConfig, thread_name: str):
        self._engine = engine
        self.config = config
        self._metrics = _ServeMetrics()
        self._lock = san_lock()          # slot/engine state
        # Admission staging on the shared input-plane queue core: bounded
        # (max_queue), instant-rejection try_put, close-and-drain shutdown.
        self._waiting = BoundedQueue(config.max_queue)
        self._rid = itertools.count()
        self._stop = san_event()
        self._thread: Optional[threading.Thread] = None
        self._thread_name = thread_name

    def _start(self):
        """Start the scheduling thread. Subclasses call this LAST in their
        ``__init__`` — the loop reads subclass state (e.g. the slot table),
        so it must not run before that state exists."""
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self._thread_name)
        self._thread.start()

    def _enqueue(self, req: ServeRequest) -> ServeRequest:
        """Admission control: better an instant rejection than an unbounded
        queue whose tail latency is infinite. O(1) host work — anything
        per-request and device-touching happens at admission, not here."""
        req.deadline = req.t_submit + self.config.request_timeout_s
        if self._stop.is_set():
            # After close() no loop thread exists to ever serve this;
            # reject now instead of parking the caller for its full
            # timeout on a queue nobody drains.
            self._metrics.rejected.inc()
            raise ServeError("server is shutting down")
        try:
            admitted = self._waiting.try_put(req)
        except QueueClosed:
            self._metrics.rejected.inc()
            raise ServeError("server is shutting down") from None
        if not admitted:
            self._metrics.rejected.inc()
            _reqtrace.mark(req.trace_key, "shed", reason="queue_full")
            raise ServeBusy(
                f"serving queue is full ({self.config.max_queue} "
                f"waiting); retry later")
        self._metrics.submitted.inc()
        self._metrics.depth.set(len(self._waiting))
        _reqtrace.mark(req.trace_key, "queued", depth=len(self._waiting))
        return req

    def queue_depth(self) -> int:
        return len(self._waiting)

    def _inflight_locked(self) -> List[ServeRequest]:
        """Hook (called under ``_lock`` from :meth:`close`): active requests
        to fail at shutdown; implementations must also detach them."""
        return []

    def in_flight_snapshot(self) -> List[dict]:
        """Wire-encodable per-request view of what is on the device right
        now (the ``status`` opcode's in-flight table): empty for batchers
        whose requests are transient (the apply path runs whole waves inside
        one ``run_once``)."""
        return []

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        # Fail whatever is still queued/in-flight so no handler waits out its
        # full timeout on a server that is gone. Closing the staging queue
        # AFTER the join also converts racing late submits into instant
        # shutting-down rejections (QueueClosed in _enqueue).
        pending = self._waiting.close()
        with self._lock:
            pending += self._inflight_locked()
        for req in pending:
            req.finish(error="server shutting down")

    def _loop(self):
        from autodist_tpu_torch.telemetry import alerts as _alerts
        from autodist_tpu_torch.telemetry import history as _history
        while not self._stop.is_set():
            # Metric-history tick between scheduler rounds: serving
            # processes have no train-loop boundary, so the SLO histograms'
            # series (and the burn-rate alert windows over them) sample
            # here. Throttled to min_interval_s inside maybe_sample; the
            # un-armed cost is two module-global reads per round. A halt
            # alert cannot stop a loop that owns live requests — log it,
            # keep serving (the gauges/events are booked for pollers).
            try:
                _history.maybe_sample(reason="serve_round")
            except _alerts.AlertHalt as e:
                from autodist_tpu_torch.utils import logging as _logging
                _logging.warning("serving: %s (AUTODIST_ALERT_ACTION=halt "
                                 "does not stop the scheduler loop; drain "
                                 "via the router instead)", e)
            # Per-round phase attribution: fold the completions this round
            # observed into the serve.attr.* share gauges (no-op when no
            # request completed since the last round).
            self._metrics.flush_attr()
            if not self.run_once() and not self._stop.is_set():
                # Bounded idle poll on the staging queue (wakes instantly
                # on an admission, at IDLE_WAIT_S otherwise).
                self._waiting.wait_nonempty(self.IDLE_WAIT_S)

    def _drop_dead(self, req: ServeRequest):
        """A request whose client stopped waiting (abandoned) or whose
        server-side deadline passed: reply with the reason, count it
        rejected, never touch the device for it."""
        req.finish(error="request abandoned by its client" if req.abandoned
                   else "request timed out (request_timeout_s passed)")
        self._metrics.rejected.inc()
        _reqtrace.mark(req.trace_key, "shed",
                       reason="abandoned" if req.abandoned else "deadline")


class Batcher(_BatcherBase):
    """Continuous/static batching loop over an LM engine.

    The engine interface (implemented by ``runtime.LMEngine``, faked in
    tests): ``capacity`` (slot count), ``admit(slot, prompt, key) -> int``
    (prefill + first sampled token), ``step(keys) -> np[int32 B]`` (one
    decode step for every slot), ``free(slot)``, ``make_keys(seed, n)``
    (per-step sampling seeds, int64 ``[n]``; None for greedy engines).

    ``start=False`` leaves the loop un-started (tests drive :meth:`run_once`
    by hand for deterministic admission/step interleaving).
    """

    kind = "lm"

    def __init__(self, engine, config: ServeConfig, start: bool = True):
        super().__init__(engine, config, "serve-batcher")
        self._slots: List[Optional[ServeRequest]] = [None] * engine.capacity
        # Admission holdback: a request popped from the queue that the
        # engine cannot admit YET (paged engines gate on free pages, not
        # free slots) parks here and is retried FIRST next round —
        # BoundedQueue has no push-front, and skipping it would reorder
        # FIFO admission. Guarded by _lock: _admit_ready swaps it out and
        # restores it under the lock, and close() collects it via
        # _inflight_locked — if join(30) times out the scheduler thread is
        # still live, so the bare-access version raced.
        self._held: Optional[ServeRequest] = None
        # Paged engines accept the trace rid on can_admit (they mark the
        # admission wait behind the page budget); plain engines/fakes keep
        # the two-argument form. Resolved once, not per admission round.
        ca = getattr(engine, "can_admit", None)
        self._can_admit_rid = (ca is not None and
                               "rid" in inspect.signature(ca).parameters)
        if start:
            self._start()

    # ------------------------------------------------------------- admission

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               seed: int = 0, rid_token: Optional[str] = None,
               wire_s: float = 0.0) -> ServeRequest:
        """Validate + enqueue; returns the request whose ``done`` event the
        caller waits on. Raises :class:`ServeError` on an invalid request or
        a full queue. The sampling-key schedule is built at ADMISSION, not
        here — a rejected request must cost no device work. ``rid_token`` /
        ``wire_s`` are the transport's trace context: the fleet-scope rid
        and the decomposed wire seconds (see :class:`ServeRequest`)."""
        prompt = self._validate(prompt, max_new_tokens)
        return self._enqueue(ServeRequest(next(self._rid), prompt,
                                          max_new_tokens, seed=seed,
                                          rid_token=rid_token,
                                          wire_s=wire_s))

    def _validate(self, prompt, max_new_tokens: int) -> np.ndarray:
        if not isinstance(prompt, np.ndarray) or prompt.ndim != 1 \
                or prompt.dtype.kind not in "iu" or prompt.size < 1:
            raise ServeError(
                f"prompt must be a non-empty 1-D integer ndarray, got "
                f"{type(prompt).__name__}"
                + (f" {prompt.dtype}/{prompt.shape}"
                   if isinstance(prompt, np.ndarray) else ""))
        if not isinstance(max_new_tokens, int) or max_new_tokens < 1:
            raise ServeError(f"max_new_tokens must be a positive int, got "
                             f"{max_new_tokens!r}")
        # Bucket fit + cache fit (prompt pads to its bucket; generation
        # extends from the TRUE length, so prompt+new bounds the frontier).
        bucket_for(prompt.size, self._engine.buckets)
        limit = self._engine.max_len
        if prompt.size + max_new_tokens > limit:
            raise ServeError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_len ({limit})")
        return prompt.astype(np.int32)

    # ------------------------------------------------------------------ loop

    def _inflight_locked(self) -> List[ServeRequest]:
        inflight = [r for r in self._slots if r is not None]
        self._slots = [None] * len(self._slots)
        if self._held is not None:
            inflight.append(self._held)
            self._held = None
        return inflight

    @property
    def num_active(self) -> int:
        with self._lock:
            return sum(r is not None for r in self._slots)

    def in_flight_snapshot(self) -> List[dict]:
        """One dict per occupied decode slot: request id, slot, seconds in
        the system, tokens generated so far, prompt length — what an
        operator needs to spot the request a batch is convoyed behind."""
        now = time.perf_counter()
        with self._lock:
            slots = list(enumerate(self._slots))
        out = []
        for slot, req in slots:
            if req is None:
                continue
            out.append({"request_id": req.rid, "slot": slot,
                        "age_s": round(now - req.t_submit, 3),
                        "tokens": len(req.tokens),
                        "prompt_len": int(req.prompt.size),
                        "max_new_tokens": int(req.max_new_tokens)})
        return out

    def run_once(self) -> bool:
        """One scheduling round: admit what the mode allows, then one decode
        step for the active batch. Returns False when there was nothing to
        do (the loop then parks briefly). Tests call this directly for
        deterministic interleaving."""
        self._admit_ready()
        with self._lock:
            active = [(s, r) for s, r in enumerate(self._slots)
                      if r is not None]
            n_slots = len(self._slots)
        # An in-flight request whose client gave up — or whose deadline
        # passed mid-generation — leaves the batch NOW; its remaining decode
        # budget goes to live requests instead.
        now = time.perf_counter()
        for slot, req in [a for a in active if a[1].dead(now)]:
            self._release(slot)
            self._drop_dead(req)
            active = [a for a in active if a[0] != slot]
        self._metrics.fill.set(round(len(active) / max(1, n_slots), 4))
        if not active:
            return False
        keys = self._step_keys(active, n_slots)
        # The rids join is per-TOKEN work in the scheduler thread: build it
        # only when the span will actually record it (disabled-mode serving
        # must stay at the one-attribute-check contract).
        rids = ",".join(str(r.rid) for _, r in active) \
            if telemetry.enabled() else ""
        with telemetry.span("serve.decode_step", active=len(active),
                            rids=rids):
            toks = self._engine.step(keys)
        for slot, req in active:
            tok = int(toks[slot])
            req.tokens.append(tok)
            if len(req.tokens) >= req.max_new_tokens \
                    or tok == self.config.eos_id:
                self._complete(slot, req)
        return True

    def _step_keys(self, active, n_slots: int) -> np.ndarray:
        keys = np.zeros(n_slots, np.int64)
        for slot, req in active:
            if req.keys is not None and len(req.tokens) < len(req.keys):
                keys[slot] = req.keys[len(req.tokens)]
        return keys

    def _admit_ready(self):
        """Admission policy: continuous admits into any free slot at every
        round; static admits only a fresh wave into an EMPTY batch. Prefill
        (device work) runs OUTSIDE the queue lock — only the pop is locked.
        Dead waiters (abandoned / past deadline) are dropped at the pop, so
        under overload a backlog of expired requests never reaches the
        device."""
        now = time.perf_counter()
        dropped: List[ServeRequest] = []
        # _held is shared with close() (which collects it under _lock via
        # _inflight_locked, and may run concurrently if join(30) expires):
        # swap it out under the lock, work on the local, and restore any
        # held-back request under the same lock that publishes the batch.
        with self._lock:
            free = [s for s, r in enumerate(self._slots) if r is None]
            n_slots = len(self._slots)
            held, self._held = self._held, None
        if ((held is None and not len(self._waiting)) or not free
                or (self.config.mode == "static" and len(free) != n_slots)):
            if held is not None:
                with self._lock:
                    self._held = held
            return
        # Paged engines expose can_admit(prompt_len, max_new) — admission
        # gates on RESERVABLE PAGES, not free slots. A request that cannot
        # be admitted yet holds back (FIFO preserved); one that can NEVER
        # fit (needs more pages than the pool owns) raises and is rejected
        # here instead of blocking the head of the line forever.
        can_admit = getattr(self._engine, "can_admit", None)
        batch: List[Tuple[int, ServeRequest]] = []
        while free:
            if held is not None:
                req, held, fresh = held, None, False
            else:
                req = self._waiting.pop_nowait()
                fresh = True
                if req is EMPTY:
                    break
            if req.dead(now):
                dropped.append(req)
                continue
            if can_admit is not None:
                try:
                    # The trace rid rides only the FIRST check: a held-back
                    # request is re-checked every round, and one admit_wait
                    # mark per wait (not per 20ms retry) is the record.
                    if self._can_admit_rid and fresh:
                        ok = can_admit(int(req.prompt.size),
                                       req.max_new_tokens, rid=req.trace_key)
                    else:
                        ok = can_admit(int(req.prompt.size),
                                       req.max_new_tokens)
                except ServeError as e:
                    req.finish(error=str(e))
                    self._metrics.rejected.inc()
                    continue
                if not ok:
                    held = req
                    break
            batch.append((free.pop(0), req))
        self._metrics.depth.set(len(self._waiting))
        with self._lock:
            if held is not None:
                self._held = held
            for slot, req in batch:
                self._slots[slot] = req
        for req in dropped:
            self._drop_dead(req)
        for slot, req in batch:
            req.t_admit = time.perf_counter()
            req.slot = slot
            _reqtrace.mark(req.trace_key, "admitted", slot=slot)
            # Key schedule built here, not in submit(): only admitted
            # requests may cost device work.
            req.keys = self._engine.make_keys(req.seed, req.max_new_tokens)
            _reqtrace.mark(req.trace_key, "prefill_start",
                           prompt_len=int(req.prompt.size))
            try:
                with telemetry.span("serve.prefill", slot=slot, rid=req.rid,
                                    prompt_len=int(req.prompt.size)):
                    first = self._engine.admit(
                        slot, req.prompt,
                        req.keys[0] if req.keys is not None
                        and len(req.keys) else None)
            except Exception as e:   # a bad admit must not kill the loop
                self._release(slot)
                req.finish(error=f"{type(e).__name__}: {e}")
                self._metrics.rejected.inc()
                continue
            req.t_prefill_done = time.perf_counter()
            _reqtrace.mark(req.trace_key, "prefill_end")
            _reqtrace.mark(req.trace_key, "first_token")
            req.tokens.append(int(first))
            if len(req.tokens) >= req.max_new_tokens \
                    or int(first) == self.config.eos_id:
                self._complete(slot, req)

    def _release(self, slot: int):
        """Free a slot's engine cache row and unbind it (no cache scrub
        needed — the next occupant's prefill overwrites [0, bucket) and its
        mask never reaches past its own frontier)."""
        self._engine.free(slot)
        with self._lock:
            self._slots[slot] = None

    def _complete(self, slot: int, req: ServeRequest):
        """Early exit: the finished request leaves the batch NOW, freeing its
        KV-cache slot for the next waiter."""
        self._release(slot)
        req.stamp_done()
        _reqtrace.mark(req.trace_key, "done", tokens=len(req.tokens))
        self._metrics.completed.inc()
        self._metrics.observe(req)
        req.done.set()


class ApplyBatcher(_BatcherBase):
    """Dynamic batcher for the stateless families (classifier / recommender):
    gather whatever is waiting (up to ``max_batch``), run ONE padded jitted
    ``apply``, split the outputs back per request. No KV cache, no slots —
    a request's payload is one example pytree and its result one output
    pytree. The engine interface: ``capacity``, ``run(examples) -> outputs``
    (list in, list out, same order)."""

    kind = "apply"

    def __init__(self, engine, config: ServeConfig, start: bool = True):
        super().__init__(engine, config, "serve-apply-batcher")
        if start:
            self._start()

    def submit(self, example) -> ServeRequest:
        return self._enqueue(ServeRequest(next(self._rid), example))

    def run_once(self) -> bool:
        now = time.perf_counter()
        dropped: List[ServeRequest] = []
        batch: List[ServeRequest] = []
        while len(batch) < self._engine.capacity:
            req = self._waiting.pop_nowait()
            if req is EMPTY:
                break
            (dropped if req.dead(now) else batch).append(req)
        self._metrics.depth.set(len(self._waiting))
        for req in dropped:
            self._drop_dead(req)
        if not batch:
            return bool(dropped)
        now = time.perf_counter()
        for req in batch:
            req.t_admit = req.t_prefill_done = now
        self._metrics.fill.set(
            round(len(batch) / max(1, self._engine.capacity), 4))
        try:
            with telemetry.span("serve.apply", batch=len(batch)):
                outs = self._engine.run([r.prompt for r in batch])
        except Exception as e:
            for req in batch:
                req.finish(error=f"{type(e).__name__}: {e}")
                self._metrics.rejected.inc()
            return True
        for req, out in zip(batch, outs):
            req.output = out
            req.stamp_done()
            self._metrics.completed.inc()
            self._metrics.observe(req)
            req.done.set()
        return True
