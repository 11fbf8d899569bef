"""Empirical strategy tuning: measure candidate builders, pick the fastest
(the port's copy of ``autodist_tpu/strategy/tuner.py:31-287``).

Where :class:`~autodist_tpu_torch.strategy.auto_strategy.AutoStrategy`
predicts, the tuner measures: each candidate is built and run for a few
steps on the real model, batch and device, and the winner is what was
fastest. Candidates that fail to build or run are recorded and skipped.

:func:`measure_candidate` is the one build, run and timing loop:
:func:`tune_strategy` drives it over its sweep, and the plan autotuner
(:mod:`autodist_tpu_torch.strategy.autotune`) reuses it for its stage-2
probes, so the failure-skip semantics cannot drift apart. With
``unroll=K`` each timed dispatch is a K-step block through ``run_many``
(one CUDA graph replay on the card), and steps/s counts optimizer steps.
"""

import dataclasses
import gc
import logging
import numbers
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder

_log = logging.getLogger("autodist_tpu_torch")


@dataclasses.dataclass
class CandidateResult:
    builder: StrategyBuilder
    name: str
    steps_per_sec: Optional[float]    # None: failed or skipped
    error: Optional[str] = None
    accumulation_steps: int = 1
    unroll: int = 1
    zero: int = 0


@dataclasses.dataclass
class TuneResult:
    best: StrategyBuilder
    results: List[CandidateResult]
    best_accumulation_steps: int = 1

    def report(self) -> str:
        """Human-readable ranking table."""
        rows = sorted(self.results, key=lambda r: -(r.steps_per_sec or float("-inf")))
        width = max(len(r.name) for r in rows)
        lines = []
        for r in rows:
            if r.steps_per_sec is None:
                label = "SKIPPED" if (r.error or "").startswith("skipped") else "FAILED"
                lines.append(f"{r.name:<{width}}  {label}: {r.error}")
            else:
                marker = "  <- best" if (
                    r.builder is self.best
                    and r.accumulation_steps == self.best_accumulation_steps) else ""
                lines.append(f"{r.name:<{width}}  {r.steps_per_sec:8.2f} steps/s{marker}")
        return "\n".join(lines)


def _default_candidates(has_sparse: bool) -> List[StrategyBuilder]:
    from autodist_tpu_torch.strategy import AllReduce, AutoStrategy, Parallax, PSLoadBalancing
    cands: List[StrategyBuilder] = [AllReduce(), PSLoadBalancing(), AutoStrategy()]
    if has_sparse:
        cands.insert(2, Parallax())
    return cands


def _check_loop(warmup_steps: int, measure_steps: int) -> None:
    if warmup_steps < 1:
        raise ValueError("warmup_steps must be >= 1 (the timed loop needs a built, "
                         "fenced step to start from)")
    if measure_steps < 1:
        raise ValueError("measure_steps must be >= 1")


def _fence(loss) -> None:
    """Read the (possibly ``[K]``-stacked) loss back: the fence both ends of
    the timed loop need."""
    loss.reshape(-1)[-1].item()


def measure_candidate(builder: StrategyBuilder, loss_fn: Callable, params: Any,
                      optimizer: Callable, example_batch: Any, *,
                      name: Optional[str] = None,
                      resource_spec: Optional[ResourceSpec] = None,
                      warmup_steps: int = 2, measure_steps: int = 8,
                      sparse_names: Optional[Sequence[str]] = None,
                      has_aux: bool = False, accumulation_steps: int = 1,
                      unroll: int = 1, zero: Optional[int] = None,
                      device=None) -> CandidateResult:
    """Build one candidate's session and time a few real steps on this
    process's device (``tuner.py:90-196``).

    ``warmup_steps`` dispatches (the first build, capture and warm-up,
    fenced by a read of the loss), then ``measure_steps`` timed ones; with
    ``unroll=K`` each dispatch is ``run_many`` over a block of K copies of
    the batch, so ``steps_per_sec`` counts optimizer steps at every unroll.
    The batch (or block) is placed once, so the loop measures the strategy
    and its knobs, not the host link. ``zero=None`` leaves the session to
    ``AUTODIST_ZERO``.

    Failure-skip semantics: a candidate that fails to build or run comes
    back with ``steps_per_sec=None`` and the error; one whose plan is
    asynchronous (``sync=False`` / ``staleness > 0``) is recorded as
    skipped, as the JAX package records it (the port raises on that regime
    until it is ported). The candidate's runner and state are dropped, and
    the card's cached memory freed, before this returns."""
    from autodist_tpu_torch.autodist import AutoDist

    _check_loop(warmup_steps, measure_steps)
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    name = name or type(builder).__name__
    zero_rec = int(zero or 0)
    record = dict(accumulation_steps=accumulation_steps, unroll=unroll, zero=zero_rec)
    ad = runner = state = batch = fetched = None
    try:
        ad = AutoDist(resource_spec, builder, device=device)
        plan = ad._plan(loss_fn, params, optimizer, example_batch, sparse_names)[2]
        if plan.is_async:
            _log.warning("measure_candidate %s: skipped (async regime)", name)
            return CandidateResult(
                builder, name, None,
                "skipped: async candidate (sync=False / staleness>0) — candidate "
                "measurement ranks synchronous strategies only", **record)
        runner = ad.create_distributed_session(
            loss_fn, params, optimizer, example_batch=example_batch,
            sparse_names=sparse_names, has_aux=has_aux,
            accumulation_steps=accumulation_steps, zero=zero, tune=False)
        state = runner.init(params)
        if unroll > 1:
            batch = runner.shard_block([example_batch] * unroll)
            run_once = lambda: runner.run_many(state, batch)[1]  # noqa: E731
        else:
            batch = runner.shard_batch(example_batch)
            run_once = lambda: runner.run(state, batch)[1]  # noqa: E731
        for _ in range(warmup_steps):
            fetched = run_once()
        _fence(fetched[0] if has_aux else fetched)
        t0 = time.perf_counter()
        for _ in range(measure_steps):
            fetched = run_once()
        _fence(fetched[0] if has_aux else fetched)
        rate = measure_steps * unroll / (time.perf_counter() - t0)
        _log.info("measure_candidate %s: %.2f steps/s", name, rate)
        return CandidateResult(builder, name, rate, **record)
    except Exception as e:  # noqa: BLE001 — a failing candidate must not abort the search
        _log.warning("measure_candidate %s failed: %s", name, e)
        return CandidateResult(builder, name, None, f"{type(e).__name__}: {e}", **record)
    finally:
        ad = runner = state = batch = fetched = None  # noqa: F841
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def tune_strategy(loss_fn: Callable, params: Any, optimizer: Callable, example_batch: Any,
                  candidates: Optional[Sequence[StrategyBuilder]] = None,
                  resource_spec: Optional[ResourceSpec] = None,
                  warmup_steps: int = 2, measure_steps: int = 8,
                  sparse_names: Optional[Sequence[str]] = None,
                  has_aux: bool = False, accumulation_steps=1,
                  device=None) -> TuneResult:
    """Measure each candidate builder on the real model, batch and device;
    returns the fastest and the full ranking (``tuner.py:206-287``).

    Ranking is synchronous and local: a multi-node ``resource_spec`` is
    refused, and an async candidate is recorded as skipped.
    ``accumulation_steps`` is an int or a sequence to sweep (each candidate
    at each value); ``result.best_accumulation_steps`` is the winner's."""
    from autodist_tpu_torch.model_spec import ModelSpec

    _check_loop(warmup_steps, measure_steps)
    if resource_spec is not None and resource_spec.num_nodes > 1:
        raise ValueError(
            "tune_strategy measures candidates synchronously on THIS process's local "
            "devices; a multi-node resource spec would be ranked by a measurement that "
            "ignores the cross-node wire. Tune with a single-node spec, or benchmark "
            "multi-node candidates through a real cluster launch")
    if isinstance(accumulation_steps, bool):
        raise TypeError("accumulation_steps must be an int or a sequence of ints, not a bool")
    sweep = ([accumulation_steps] if isinstance(accumulation_steps, numbers.Integral)
             else tuple(accumulation_steps))
    if not sweep or any(isinstance(a, bool) or not isinstance(a, numbers.Integral) or a < 1
                        for a in sweep):
        raise ValueError(f"accumulation_steps must be an int >= 1 or a non-empty sequence "
                         f"of such ints, got {accumulation_steps!r}")
    sweep = [int(a) for a in sweep]
    if candidates is None:
        spec = (ModelSpec(params, sparse_names=sparse_names) if sparse_names is not None
                else ModelSpec.from_loss_fn(loss_fn, params, example_batch))
        candidates = _default_candidates(any(p.sparse for p in spec.trainable.values()))

    results: List[CandidateResult] = []
    for builder in candidates:
        for accum in sweep:
            name = type(builder).__name__
            if len(sweep) > 1:
                name = f"{name}[accum={accum}]"
            results.append(measure_candidate(
                builder, loss_fn, params, optimizer, example_batch, name=name,
                resource_spec=resource_spec, warmup_steps=warmup_steps,
                measure_steps=measure_steps, sparse_names=sparse_names, has_aux=has_aux,
                accumulation_steps=accum, device=device))
    ranked = [r for r in results if r.steps_per_sec is not None]
    if not ranked:
        raise RuntimeError("tune_strategy: every candidate failed or was skipped:\n"
                           + "\n".join(f"  {r.name}: {r.error}" for r in results))
    best = max(ranked, key=lambda r: r.steps_per_sec)
    _log.info("tune_strategy winner: %s (%.2f steps/s)", best.name, best.steps_per_sec)
    return TuneResult(best=best.builder, results=results,
                      best_accumulation_steps=best.accumulation_steps)
