"""Declarative SLO / drift alerting over the metric history.

Every detector the stack grew so far is hard-coded (the watchdog's 3-tick
stall rule, the health monitor's z-score) — operable fleets express "page me
when" as DATA. A rule here is a metric selector plus a predicate, evaluated
on every :class:`~autodist_tpu_torch.telemetry.history.MetricsHistory` sample:

- ``threshold`` — compare a metric's current value against ``value`` with
  ``op`` (``> >= < <=``); ``for_s`` makes the condition hold continuously
  over that much history before firing (one bad tick is noise, five minutes
  of bad ticks is an incident).
- ``burn_rate`` — the multi-window SLO form: the ``q``-quantile of a LATENCY
  HISTOGRAM's delta over a long and a short window must BOTH exceed
  ``objective_s`` (the Google-SRE burn-rate construction: the long window
  proves budget is burning, the short window proves it is burning NOW — a
  recovered blip auto-resolves). Quantiles come from the shared
  :func:`telemetry.metrics.quantile` helper, windows from the history ring.
- ``drift`` — compare a live gauge against a REFERENCE band: ``ref`` explicit,
  ``ref_from="plan"`` derives it from the applied tuned plan's predicted
  breakdown (:func:`telemetry.profiling.applied_plan` — the Automap-style
  "live shares left the plan's predicted bound" trigger an online retuner
  consumes), ``ref_from="window_max"`` self-references the metric's
  own windowed peak (MFU collapse). ``direction`` picks the bad side;
  ``relative=True`` scales ``band`` by the reference.

Metric selectors ending in ``.*`` fan out over every matching registry name
and take the WORST value for the rule's direction (``ps.worker.last_seen_s.*``
alerts on the most-silent worker).

Firing books ``alert.active.<rule>``/``alert.active`` gauges (they ride the
``/metrics`` exposition and the ``status`` opcode with zero extra wiring),
emits a structured ``alert`` event into the existing ring, bumps
``alert.fired``, triggers the flight recorder THROUGH ITS DEBOUNCE, and
honors ``AUTODIST_ALERT_ACTION``: ``warn`` logs (rate-limited), ``record``
arms a recorder on demand, ``halt`` raises :class:`AlertHalt` out of the
sampling loop (the train loop propagates it; background samplers catch and
log), ``recover`` raises :class:`AlertRecover` — the train loop rolls back
to its last-known-good snapshot and resumes (``parallel/recovery.py``).
Rules load from ``AUTODIST_ALERT_RULES`` (a JSON file path or inline
JSON) on top of :data:`DEFAULT_RULES`; a malformed rule WARNS AND IS
SKIPPED — alerting must never crash the loop it watches.
"""

import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.telemetry import metrics as _metrics
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.testing.sanitizer import san_lock

__all__ = ["AlertRule", "AlertEngine", "AlertHalt", "AlertRecover",
           "DEFAULT_RULES", "load_rules", "set_engine", "get_engine",
           "get_or_create", "active_alerts", "alerts_snapshot"]

ACTIONS = ("warn", "record", "halt", "recover")
KINDS = ("threshold", "burn_rate", "drift")
_OPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}

# Shipped defaults — the incidents the existing planes can already diagnose
# but nothing watches for. AUTODIST_ALERT_RULES entries with the same name
# override; ``{"defaults": false}`` in the loaded document drops them.
DEFAULT_RULES: List[Dict[str, Any]] = [
    # Serving SLO: p99 total latency burning through a 1s objective in both
    # the 5-minute and 1-minute windows. The objective must sit STRICTLY
    # below MS_BUCKETS' top finite edge (2.5s): the shared quantile
    # estimator answers at most that edge (the +inf bucket's honest lower
    # bound), so an objective at/above it could never be exceeded and the
    # rule could never fire.
    {"name": "serve_p99_burn", "kind": "burn_rate",
     "metric": "serve.latency_s.total", "q": 0.99, "objective_s": 1.0,
     "long_s": 300.0, "short_s": 60.0},
    # Input-pipeline drift: the data_wait share left the tuned plan's
    # predicted bound (the plan predicts ~0 data_wait; a loader regression
    # shows up here first).
    {"name": "data_wait_drift", "kind": "drift",
     "metric": "train.attr.data_wait", "ref_from": "plan", "band": 0.25,
     "direction": "above", "for_s": 0.0},
    # Staleness: a worker silent for two minutes is parked at the bound or
    # gone (the watchdog flags it; this makes it a declarative page).
    {"name": "worker_stalled", "kind": "threshold",
     "metric": "ps.worker.last_seen_s.*", "op": ">", "value": 120.0},
    # MFU collapse: achieved MFU dropped below half its own 10-minute peak
    # (a straggler, a thermal throttle, a bad plan hot-swap).
    {"name": "mfu_collapse", "kind": "drift", "metric": "train.mfu",
     "ref_from": "window_max", "window_s": 600.0, "band": 0.5,
     "relative": True, "direction": "below"},
    # Memory pressure: the memory plane's worst-device used/limit ratio
    # (mem.pressure, booked by every sample_device_memory pass) held above
    # the default AUTODIST_MEM_PRESSURE threshold for 30s. Sustained, not
    # a spike: one fragmentation burp at a compile boundary should not
    # page. On serving kinds the same plane also tightens paged-KV
    # admission (memplane.kv_admission_holdback) — the rule is the page,
    # the holdback is the reflex.
    {"name": "mem_pressure", "kind": "threshold", "metric": "mem.pressure",
     "op": ">", "value": 0.92, "for_s": 30.0},
]


class AlertHalt(RuntimeError):
    """Raised out of the sampling call under ``AUTODIST_ALERT_ACTION=halt``:
    an alert rule fired and policy says stop. Carries the firing records,
    and — when the train loop is the sampler — the live ``TrainState`` on
    ``.state`` (attached at the raise's boundary call site, the
    :class:`HealthHalt` contract: a halt must leave the state inspectable
    and checkpointable, not discard the run's progress)."""

    def __init__(self, fired: List[Dict[str, Any]]):
        names = ",".join(sorted({f["rule"] for f in fired}))
        super().__init__(f"alert rule(s) fired with action=halt: {names}")
        self.fired = fired
        self.state = None   # the live TrainState, when a train loop raised


class AlertRecover(AlertHalt):
    """The ``AUTODIST_ALERT_ACTION=recover`` control signal — the health
    plane's recover action, driven by a declarative rule instead of the
    numerics bundle. ``train()`` catches it, rolls back to the newest
    last-known-good snapshot (``parallel/recovery.py``) and resumes,
    escalating after ``AUTODIST_RECOVER_MAX`` attempts; background samplers
    (timer/scheduler threads) catch it as the :class:`AlertHalt` it
    subclasses and log — a loop with live requests is not theirs to roll
    back."""


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule (see the module docstring for the grammar)."""

    name: str
    kind: str                       # threshold | burn_rate | drift
    metric: str                     # registry name; trailing ".*" fans out
    op: str = ">"                   # threshold comparator
    value: float = 0.0              # threshold bound
    for_s: float = 0.0              # condition must hold this long
    q: float = 0.99                 # burn-rate quantile
    objective_s: float = 1.0        # burn-rate SLO target for the quantile
    long_s: float = 300.0           # burn-rate long window
    short_s: float = 60.0           # burn-rate short window
    band: float = 0.1               # drift band width
    direction: str = "above"        # drift bad side: above | below
    ref: Optional[float] = None     # drift explicit reference
    ref_from: str = ""              # drift reference source: plan | window_max
    relative: bool = False          # drift band scales by the reference
    window_s: float = 600.0         # drift window_max lookback
    min_coverage: float = 0.5       # burn-rate: each window's sample span
    #                                 must cover this fraction of it

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}; valid: {', '.join(KINDS)}")
        if not self.name or not self.metric:
            raise ValueError("a rule needs a non-empty name and metric")
        if self.kind == "threshold" and self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}; "
                             f"valid: {', '.join(_OPS)}")
        if self.direction not in ("above", "below"):
            raise ValueError(f"rule {self.name!r}: direction must be "
                             f"'above' or 'below'")
        if self.kind == "drift" and self.ref is None \
                and self.ref_from not in ("plan", "window_max"):
            raise ValueError(f"rule {self.name!r}: drift needs ref, or "
                             f"ref_from 'plan' or 'window_max'")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlertRule":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"rule {d.get('name', '?')!r}: unknown "
                             f"field(s) {', '.join(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    # ----------------------------------------------------------- evaluation

    def _select(self, metrics: Dict[str, Any]) -> Optional[float]:
        """The rule's scalar from one sample's metrics: exact name, or the
        worst match of a ``prefix.*`` fan-out (max for 'above'-is-bad rules
        and thresholds that fire upward, min for the opposite side)."""
        if not self.metric.endswith(".*"):
            v = metrics.get(self.metric)
            return float(v) if isinstance(v, (int, float)) else None
        prefix = self.metric[:-1]   # keep the trailing dot
        vals = [float(v) for k, v in metrics.items()
                if k.startswith(prefix) and isinstance(v, (int, float))]
        if not vals:
            return None
        bad_high = (self.op in (">", ">=") if self.kind == "threshold"
                    else self.direction == "above")
        return max(vals) if bad_high else min(vals)

    def _holds(self, value: float, bound: float) -> bool:
        if self.kind == "threshold":
            return _OPS[self.op](value, bound)
        if self.direction == "above":
            return value - bound > self._band(bound)
        return bound - value > self._band(bound)

    def _band(self, ref: float) -> float:
        return abs(ref) * self.band if self.relative else self.band

    def _reference(self, history) -> Optional[float]:
        if self.ref is not None:
            return float(self.ref)
        if self.ref_from == "plan":
            from autodist_tpu_torch.telemetry import profiling as _profiling
            plan = _profiling.applied_plan()
            pred = (plan or {}).get("predicted") or {}
            step_s = pred.get("step_s")
            breakdown = pred.get("breakdown") or {}
            if not step_s:
                return None
            # The plan's predicted per-step breakdown as attribution shares:
            # phases the model does not price (readback) are predicted 0 —
            # exactly the bound drift is measured against. data_wait maps
            # to the cost model's residual-loader term (max(0, loader_s -
            # hidden_s)): a plan that priced a slow loader as hidden
            # behind prefetch_depth predicts ~0 and the drift rule pages
            # the moment the pipeline stops hiding it.
            phase = self.metric.rsplit(".", 1)[-1]
            share = {"compute": breakdown.get("compute_s", 0.0),
                     "comm": breakdown.get("comm_s", 0.0),
                     "host": breakdown.get("host_s", 0.0),
                     "data_wait": breakdown.get("data_wait_s", 0.0)
                     }.get(phase, 0.0)
            return float(share) / float(step_s) if share else 0.0
        if self.ref_from == "window_max":
            series = [v for _, v in history.series(self.metric,
                                                   window_s=self.window_s)
                      if isinstance(v, (int, float))]
            return max(series) if series else None
        return None

    def evaluate(self, history) -> Optional[Dict[str, Any]]:
        """Firing detail dict when the rule's condition holds on ``history``'s
        latest sample (and over ``for_s`` of it), else None."""
        latest = history.latest()
        if latest is None:
            return None
        if self.kind == "burn_rate":
            return self._evaluate_burn(history)
        if self.kind == "drift":
            bound = self._reference(history)
            if bound is None:
                return None       # no reference yet -> the rule is inert
        else:
            bound = self.value
        value = self._select(latest["metrics"])
        if value is None or not math.isfinite(value):
            return None
        if not self._holds(value, bound):
            return None
        if self.for_s > 0:
            # Duration: the condition must hold over for_s of ACTUAL history
            # — which needs (a) at least one sample OLD enough to prove the
            # ring covers the window (a single fresh sample proves nothing
            # about duration), and (b) every sample inside the window
            # agreeing. The boundary sample itself must agree too: it is the
            # evidence the condition already held when the window opened.
            cut = latest["t_mono_s"] - self.for_s
            older = [s for s in history.samples() if s["t_mono_s"] <= cut]
            if not older:
                return None
            for s in history.window(self.for_s) + [older[-1]]:
                v = self._select(s["metrics"])
                if v is None or not self._holds(v, bound):
                    return None
        detail = {"value": round(value, 6), "bound": round(float(bound), 6)}
        if self.kind == "drift":
            detail["band"] = round(self._band(bound), 6)
        return detail

    def _evaluate_burn(self, history) -> Optional[Dict[str, Any]]:
        qs = {}
        for label, win_s in (("long", self.long_s), ("short", self.short_s)):
            window = history.window(win_s)
            if len(window) < 2:
                return None       # a burn rate needs a window to burn over
            # Coverage: the window's samples must SPAN a meaningful fraction
            # of it — a process 20s old would otherwise evaluate its "5m"
            # window over the same two fresh samples as the 1m one, and a
            # warmup blip would page as a sustained burn (the threshold
            # predicate's for_s coverage rule, applied per window).
            span = window[-1]["t_mono_s"] - window[0]["t_mono_s"]
            if span < self.min_coverage * win_s:
                return None
            new = window[-1]["metrics"].get(self.metric)
            old = window[0]["metrics"].get(self.metric)
            if not isinstance(new, dict) or not isinstance(old, dict):
                return None
            delta = {k: new.get(k, 0) - old.get(k, 0) for k in new
                     if isinstance(new.get(k), (int, float))}
            q = _metrics.quantile(delta, self.q)
            if q is None or q <= self.objective_s:
                return None
            # :g, not int(): int truncates (q=0.57 -> "p56") and collapses
            # sub-percent quantiles (0.999 and 0.995 both -> "p99").
            qs[f"p{self.q * 100:g}_{label}_s"] = round(q, 6)
        return dict(qs, objective_s=self.objective_s)


def load_rules(raw: Optional[str] = None) -> List[AlertRule]:
    """The rule set: :data:`DEFAULT_RULES` overlaid with
    ``AUTODIST_ALERT_RULES`` (or ``raw``) — a JSON file path, or inline JSON
    (``[...]`` rule list, or ``{"rules": [...], "defaults": false}`` to drop
    the shipped set). Same-name entries REPLACE defaults. Every malformed
    rule (and an unreadable/unparseable source) degrades to a warning —
    a typo in an alert file must never take down the run it watches."""
    if raw is None:
        raw = str(const.ENV.AUTODIST_ALERT_RULES.val)
    loaded: List[Dict[str, Any]] = []
    keep_defaults = True
    if raw:
        try:
            text = raw
            if not raw.lstrip().startswith(("[", "{")):
                with open(raw) as f:
                    text = f.read()
            doc = json.loads(text)
            if isinstance(doc, dict):
                keep_defaults = bool(doc.get("defaults", True))
                doc = doc.get("rules", [])
            if not isinstance(doc, list):
                raise ValueError("alert rules document must be a list or "
                                 "{'rules': [...]}")
            loaded = doc
        except (OSError, ValueError, TypeError) as e:
            logging.warning("alerts: cannot load AUTODIST_ALERT_RULES=%r "
                            "(%s); keeping the shipped defaults", raw, e)
            loaded, keep_defaults = [], True
    by_name: Dict[str, AlertRule] = {}
    source = (DEFAULT_RULES if keep_defaults else []) + loaded
    for d in source:
        try:
            rule = AlertRule.from_dict(dict(d))
        except (TypeError, ValueError) as e:
            logging.warning("alerts: skipping malformed rule %r: %s", d, e)
            continue
        by_name[rule.name] = rule   # later (loaded) entries replace defaults
    return list(by_name.values())


class _RuleState:
    __slots__ = ("active", "since_mono", "since_wall", "detail")

    def __init__(self):
        self.active = False
        self.since_mono = 0.0
        self.since_wall = 0.0
        self.detail: Dict[str, Any] = {}


class AlertEngine:
    """Evaluates a rule set on every history sample and owns the reaction.

    One engine per process (the history's default); tests construct their
    own. Thread-safe for the same reason the history is: boundary, scheduler
    and timer threads may all sample."""

    WARN_EVERY_S = 60.0
    RESOLVED_KEEP = 32

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 action: Optional[str] = None, recorder=None):
        self.rules = list(rules) if rules is not None else load_rules()
        self.action = (action if action is not None
                       else str(const.ENV.AUTODIST_ALERT_ACTION.val))
        if self.action not in ACTIONS:
            raise ValueError(f"unknown alert action {self.action!r}; "
                             f"valid: {', '.join(ACTIONS)}")
        self._recorder = recorder   # None -> resolved per policy at fire time
        self._lock = san_lock()
        self._state: Dict[str, _RuleState] = {r.name: _RuleState()
                                              for r in self.rules}
        self._resolved: List[Dict[str, Any]] = []
        self._last_warn = -math.inf
        self._warned_rules: set = set()
        reg = _metrics.registry()
        self._active_gauge = reg.gauge("alert.active")
        self._fired_counter = reg.counter("alert.fired")

    # ------------------------------------------------------------ evaluation

    def evaluate(self, history) -> List[Dict[str, Any]]:
        """One tick: run every rule against ``history``, book the transition
        effects, return the NEWLY-fired records. Raises :class:`AlertHalt`
        (after booking everything) when a new firing meets ``action=halt``."""
        now, wall = time.monotonic(), time.time()
        fired: List[Dict[str, Any]] = []
        resolved: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                detail = rule.evaluate(history)
            except Exception as e:   # a sick rule warns once, never crashes
                if rule.name not in self._warned_rules:
                    self._warned_rules.add(rule.name)
                    logging.warning("alerts: rule %r failed to evaluate "
                                    "(%s); treating as not firing",
                                    rule.name, e)
                detail = None
            if detail is not None and rule.kind == "burn_rate":
                # A burn-rate firing names a concrete traceable request: the
                # latency histogram's slowest-in-window exemplar (rid + phase
                # breakdown) rides into the alert record — and from there
                # into status snapshots and the flight-recorder manifest.
                inst = _metrics.registry().get(rule.metric)
                ex = (inst.exemplar()
                      if isinstance(inst, _metrics.Histogram) else None)
                if ex is not None:
                    detail = dict(detail, exemplar=ex)
            with self._lock:
                st = self._state.setdefault(rule.name, _RuleState())
                if detail is not None and not st.active:
                    st.active, st.detail = True, detail
                    st.since_mono, st.since_wall = now, wall
                    fired.append({"rule": rule.name, "kind": rule.kind,
                                  "metric": rule.metric, **detail})
                elif detail is not None:
                    st.detail = detail   # refresh the live numbers
                elif st.active:
                    st.active = False
                    resolved.append({
                        "rule": rule.name, "kind": rule.kind,
                        "metric": rule.metric, **st.detail,
                        "fired_t_wall_s": round(st.since_wall, 3),
                        "duration_s": round(now - st.since_mono, 3)})
            _metrics.gauge(f"alert.active.{rule.name}").set(
                1 if detail is not None else 0)
        with self._lock:
            self._active_gauge.set(sum(1 for s in self._state.values()
                                       if s.active))
            for rec in resolved:
                self._resolved.append(rec)
            del self._resolved[:max(0, len(self._resolved)
                                    - self.RESOLVED_KEEP)]
        for rec in resolved:
            _metrics.event("alert", state="resolved", **rec)
            logging.info("alerts: %s resolved after %.1fs", rec["rule"],
                         rec["duration_s"])
        if fired:
            self._react(fired)
        return fired

    def _react(self, fired: List[Dict[str, Any]]):
        from autodist_tpu_torch.telemetry import recorder as _recorder
        for rec in fired:
            self._fired_counter.inc()
            _metrics.event("alert", state="firing", **rec)
        names = ",".join(sorted({f["rule"] for f in fired}))
        if self.action == "record":
            # record EXPLICITLY asks for snapshots: arm on demand (the
            # health monitor's exact contract).
            if self._recorder is None:
                self._recorder = _recorder.get_or_create()
            path = self._recorder.maybe_record(f"alert.{names}")
        elif self._recorder is not None:
            path = self._recorder.maybe_record(f"alert.{names}")
        else:
            # warn/halt snapshot only through an ARMED recorder
            # (AUTODIST_RECORDER=1 or set_recorder) — the alert event is the
            # trigger, the action decides how loudly to react.
            path = _recorder.maybe_record(f"alert.{names}")
        if path:
            logging.warning("alerts: %s firing — flight-recorder snapshot "
                            "at %s", names, path)
        else:
            now = time.monotonic()
            if now - self._last_warn >= self.WARN_EVERY_S:
                self._last_warn = now
                logging.warning("alerts: %s firing: %s", names, fired[-1])
        if self.action == "halt":
            raise AlertHalt(fired)
        if self.action == "recover":
            raise AlertRecover(fired)

    # --------------------------------------------------------------- queries

    def active(self) -> List[Dict[str, Any]]:
        """Wire-encodable records of the currently-firing rules."""
        now, out = time.monotonic(), []
        with self._lock:
            for rule in self.rules:
                st = self._state.get(rule.name)
                if st is not None and st.active:
                    out.append({"rule": rule.name, "kind": rule.kind,
                                "metric": rule.metric, **st.detail,
                                "for_s": round(now - st.since_mono, 3),
                                "fired_t_wall_s": round(st.since_wall, 3)})
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``status`` opcode's ``alerts`` section: active firings plus
        the recently-resolved ring (newest last)."""
        with self._lock:
            resolved = list(self._resolved)
        return {"active": self.active(), "resolved": resolved,
                "rules": len(self.rules), "action": self.action}


# ------------------------------------------------------------ process global

_ENGINE: Optional[AlertEngine] = None
_ENGINE_LOCK = san_lock()


def set_engine(engine: Optional[AlertEngine]):
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = engine


def get_engine() -> Optional[AlertEngine]:
    return _ENGINE


def get_or_create() -> AlertEngine:
    """The process engine, created from the env rule set on first use (the
    default engine every :class:`MetricsHistory` evaluates through). A
    typo'd ``AUTODIST_ALERT_ACTION`` degrades to ``warn`` with a warning —
    this is called lazily from sampling hooks inside the train loop and the
    serving scheduler thread, where a raise would take down the loop the
    alerting is supposed to watch."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            try:
                _ENGINE = AlertEngine()
            except ValueError as e:
                logging.warning("alerts: %s; degrading to action='warn'", e)
                _ENGINE = AlertEngine(action="warn")
        return _ENGINE


def active_alerts() -> List[Dict[str, Any]]:
    """Currently-firing alert records, or [] when no engine is installed —
    the NON-CREATING accessor diagnostics use (the flight-recorder manifest
    must not grow an alert engine as a side effect of snapshotting)."""
    eng = _ENGINE
    return eng.active() if eng is not None else []


def alerts_snapshot() -> Dict[str, Any]:
    """The ``status``-opcode section: the engine's snapshot, or an empty
    shell when alerting never armed (pollers see a stable schema)."""
    eng = _ENGINE
    if eng is None:
        return {"active": [], "resolved": [], "rules": 0, "action": ""}
    return eng.snapshot()
