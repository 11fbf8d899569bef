"""Throughput metering and wire accounting (the port's copy of
``autodist_tpu/utils/metrics.py``): ``ThroughputMeter`` (``:157-282``) gives
examples/s per log period and a run average, with the first steps excluded
as warm-up and the period's readback wait recorded; ``step_many`` meters a
fused block of steps (``run_many``) at block granularity. ``WireCounters``
(``:41-124``) counts the PS transport's payload bytes, messages and codec
seconds. With telemetry on, both mirror into the registry: the readback
as the ``train.readback_wait`` span and ``train.readback_wait_s`` counter,
the wire as the ``ps.wire.*`` counters.
"""

import time
from typing import Dict, List, Optional, Union

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.testing.sanitizer import san_lock

_WIRE_TEL = None


def _wire_registry():
    """The registry's process-wide ``ps.wire.*`` counters, or None while
    telemetry is off (one ``enabled`` check an increment)."""
    if not telemetry.enabled():
        return None
    global _WIRE_TEL
    if _WIRE_TEL is None:
        reg = telemetry.registry()
        _WIRE_TEL = tuple(reg.counter(f"ps.wire.{n}") for n in (
            "bytes_sent", "msgs_sent", "encode_s", "bytes_received", "msgs_received",
            "decode_s"))
    return _WIRE_TEL


class WireCounters:
    """PS-transport accounting: payload bytes and message counts in both
    directions, cumulative encode/decode seconds. One instance a socket
    (client side) or aggregated across connections (server side, where the
    increments are locked so concurrent handler threads lose no count).
    ``mirror=False`` keeps a second view of the same traffic (the server's
    per-worker breakdown) out of the registry's ``ps.wire.*`` counters;
    :meth:`merge` never mirrors, its counts mirrored as they streamed."""

    __slots__ = ("bytes_sent", "bytes_received", "msgs_sent", "msgs_received",
                 "encode_s", "decode_s", "_lock", "_mirror")

    def __init__(self, mirror: bool = True):
        self.bytes_sent = 0
        self.bytes_received = 0
        self.msgs_sent = 0
        self.msgs_received = 0
        self.encode_s = 0.0
        self.decode_s = 0.0
        self._lock = san_lock()
        self._mirror = mirror

    def add_sent(self, nbytes: int, encode_s: float = 0.0):
        with self._lock:
            self.bytes_sent += nbytes
            self.msgs_sent += 1
            self.encode_s += encode_s
        tel = _wire_registry() if self._mirror else None
        if tel is not None:
            tel[0].inc(nbytes)
            tel[1].inc()
            tel[2].inc(encode_s)

    def add_received(self, nbytes: int, decode_s: float = 0.0):
        with self._lock:
            self.bytes_received += nbytes
            self.msgs_received += 1
            self.decode_s += decode_s
        tel = _wire_registry() if self._mirror else None
        if tel is not None:
            tel[3].inc(nbytes)
            tel[4].inc()
            tel[5].inc(decode_s)

    def snapshot(self) -> Dict[str, Union[int, float]]:
        """The six counters under one lock hold (the ``stats`` opcode's
        per-connection payload)."""
        with self._lock:
            return {"bytes_sent": self.bytes_sent, "bytes_received": self.bytes_received,
                    "msgs_sent": self.msgs_sent, "msgs_received": self.msgs_received,
                    "encode_s": self.encode_s, "decode_s": self.decode_s}

    def merge(self, other: "WireCounters"):
        """Fold another counter set into this one (a prefetched pull's bytes
        are attributed when the pull is consumed)."""
        with self._lock:
            self.bytes_sent += other.bytes_sent
            self.bytes_received += other.bytes_received
            self.msgs_sent += other.msgs_sent
            self.msgs_received += other.msgs_received
            self.encode_s += other.encode_s
            self.decode_s += other.decode_s

    def format_line(self) -> str:
        """``wire tx 12.3MB/45 rx 67.8MB/46 enc 1.2ms/msg dec 3.4ms/msg``."""
        def mb(n):
            return f"{n / 1e6:.1f}MB"
        enc = 1e3 * self.encode_s / max(self.msgs_sent, 1)
        dec = 1e3 * self.decode_s / max(self.msgs_received, 1)
        return (f"wire tx {mb(self.bytes_sent)}/{self.msgs_sent} "
                f"rx {mb(self.bytes_received)}/{self.msgs_received} "
                f"enc {enc:.2f}ms/msg dec {dec:.2f}ms/msg")


def _sync(value) -> float:
    """Read ``value`` (a step's loss tensor, or a block's ``[K]`` stack of
    them) back to the host, a completion fence for the step it came from:
    CUDA runs asynchronously, so a rate taken without it measures the
    enqueue. Returns the seconds spent blocked (0.0 for no value)."""
    if value is None:
        return 0.0
    t0 = time.perf_counter()
    if hasattr(value, "reshape"):
        with telemetry.span("train.readback_wait"):
            value.reshape(-1)[-1].item()
    elapsed = time.perf_counter() - t0
    if telemetry.enabled():
        telemetry.counter("train.readback_wait_s").inc(elapsed)
    return elapsed


class ThroughputMeter:
    """examples/sec (or tokens/sec) per log period plus a run average."""

    def __init__(self, batch_size: int, log_every: int = 100, warmup_steps: int = 1):
        self._batch_size = batch_size
        self._log_every = log_every
        self._warmup = warmup_steps
        self._step = 0
        now = time.perf_counter()
        # warmup_steps=0 counts from construction; otherwise these restart
        # when the last warm-up step lands.
        self._period_start = now
        self._run_start = now
        self._run_end: Optional[float] = None   # frozen by finish()
        self._run_steps = 0
        self._period_steps = 0   # block-mode (step_many) period accounting
        self._period_readback_s = 0.0
        # Seconds the last closed period spent blocked on the readback.
        self.last_readback_s = 0.0
        self.history: List[float] = []

    @property
    def batch_size(self) -> int:
        """Examples per step."""
        return self._batch_size

    def step(self, sync=None) -> Optional[float]:
        """Record one completed step; returns the period rate when a period
        ends. Pass the step's loss as ``sync``: at period boundaries (and the
        last warm-up step) it is read back before the clock is taken."""
        self._step += 1
        self._run_end = None   # stepping again unfreezes a finish()ed clock
        at_boundary = (self._step > self._warmup
                       and (self._run_steps + 1) % self._log_every == 0)
        if at_boundary or self._step == self._warmup:
            self._period_readback_s += _sync(sync)
        now = time.perf_counter()
        if self._step <= self._warmup:
            self._period_start = now
            self._run_start = now
            self._run_steps = 0
            return None
        self._run_steps += 1
        if self._run_steps % self._log_every == 0:
            rate = self._log_every * self._batch_size / (now - self._period_start)
            self.history.append(rate)
            self._period_start = now
            self.last_readback_s = self._period_readback_s
            self._period_readback_s = 0.0
            return rate
        return None

    def step_many(self, n: int, sync=None) -> Optional[float]:
        """Record ``n`` steps completed as one fused dispatch (a
        ``run_many`` block); returns the period rate when a period closed
        inside the block. The first call is wholly warm-up (it carries the
        block's capture); a period closes at the first block end with at
        least ``log_every`` post-warm-up steps since the last one, and the
        rate counts the steps it really holds, so periods made ragged by
        cadence-clipped blocks stay unbiased. ``sync`` is read back only
        when a period closes."""
        if n < 1:
            return None
        first = self._step == 0
        self._step += n
        self._run_end = None
        if first and self._warmup:
            _sync(sync)
            now = time.perf_counter()
            self._period_start = now
            self._run_start = now
            self._run_steps = 0
            self._period_steps = 0
            return None
        self._run_steps += n
        self._period_steps += n
        if self._period_steps < self._log_every:
            return None
        self._period_readback_s += _sync(sync)
        now = time.perf_counter()
        rate = self._period_steps * self._batch_size / (now - self._period_start)
        self.history.append(rate)
        self._period_start = now
        self._period_steps = 0
        self.last_readback_s = self._period_readback_s
        self._period_readback_s = 0.0
        return rate

    def finish(self) -> Optional[float]:
        """Freeze the run clock at training end; returns the final average.
        Idempotent; a later ``step()`` unfreezes it."""
        if self._run_end is None:
            self._run_end = time.perf_counter()
        return self.average

    @property
    def average(self) -> Optional[float]:
        """Run-average rate excluding warm-up, on the clock frozen by
        :meth:`finish` once the run has ended."""
        if not self._run_steps:
            return None
        end = self._run_end if self._run_end is not None else time.perf_counter()
        return self._run_steps * self._batch_size / (end - self._run_start)
