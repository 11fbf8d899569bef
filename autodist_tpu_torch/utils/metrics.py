"""Throughput metering (the port's copy of ``autodist_tpu/utils/metrics.py:127-282``,
``ThroughputMeter``): examples/s per log period and a run average, with the
first steps excluded as warm-up and the period's readback wait recorded.
The caller logs the period's rate.
"""

import time
from typing import List, Optional


def _sync(value) -> float:
    """Read ``value`` (a step's loss tensor) back to the host, a completion
    fence for the step it came from: CUDA runs asynchronously, so a rate
    taken without it measures the enqueue. Returns the seconds spent
    blocked (0.0 for no value)."""
    if value is None:
        return 0.0
    t0 = time.perf_counter()
    if hasattr(value, "item"):
        value.item()
    return time.perf_counter() - t0


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
