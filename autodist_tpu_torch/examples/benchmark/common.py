"""What the benchmark entry points share: the timed training loop and the
per-card MFU."""

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.metrics import ThroughputMeter


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def timed_steps(step, next_batch: Callable, batch_size: int, steps: int, log_every: int,
                logger=None) -> Tuple[float, float, Optional[int]]:
    """``steps`` calls of ``step(next_batch())``: ``(examples/s after one
    warm-up step, the final loss, peak device bytes or None on the host)``.
    Each log period's rate is printed, and logged as ``examples_per_second``
    through ``logger`` (a benchmark logger) when one is given. The final
    loss read back is the fence: trailing steps must not inflate the rate."""
    device = step.runner.device
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    meter = ThroughputMeter(batch_size=batch_size, log_every=log_every)
    loss = None
    for i in range(steps):
        loss = step(next_batch())
        rate = meter.step(sync=loss)
        if rate is not None:
            print(f"step {i + 1}: {rate:.1f} examples/s")
            if logger is not None:
                logger.log_metric("examples_per_second", rate, unit="examples/s",
                                  global_step=i + 1)
    final = float(loss)
    avg = meter.finish() or 0.0
    return avg, final, torch.cuda.max_memory_allocated(device) if on_card else None


def card_mfu(count: Callable[[], float], steps_per_sec: float,
             device: torch.device) -> Tuple[Optional[float], Optional[float]]:
    """``(FLOPs a step on this card, MFU)`` against the H100's peak, with
    ``count()`` giving the FLOPs (rank 0 prints the MFU line); ``(None,
    None)`` on the host, which has no peak to divide by."""
    if device.type != "cuda":
        if is_rank0():
            print("mfu not measured (the host has no peak to divide by)")
        return None, None
    per_step = count()
    if is_rank0():
        return per_step, flops_util.report_mfu(per_step, steps_per_sec)
    return per_step, flops_util.mfu(per_step * steps_per_sec)
