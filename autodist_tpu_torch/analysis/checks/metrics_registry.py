"""GL009 — metric/event-name registry: producers, consumers, and docs.

The fleet planes wired three kinds of metric CONSUMERS to the
telemetry registry by string name: alert-rule selectors
(``telemetry/alerts.py`` ``DEFAULT_RULES``), console field lookups
(``tools/adtop.py`` / ``tools/adfleet.py`` reading a status snapshot's
``registry`` dict), and the drift rules' ``ref_from="plan"`` phase mapping.
Every one of them fails SILENTLY on a typo: the selector never matches, the
console prints a dash, the drift trigger never fires — a review
found an alert rule that was dead on arrival for exactly this reason, and
an Automap-style re-tune loop hangs off ``train.attr.*`` drift
rules, so a typo'd selector silently disables online retuning.

GL009 makes the name vocabulary itself a checked registry (the GL007 move,
applied to metrics): it harvests every ``counter("…")`` / ``gauge("…")`` /
``histogram("…")`` / ``span("…")`` call across the WHOLE program into a
producer registry — f-string names contribute prefix patterns
(``f"train.attr.{phase}"`` books ``train.attr.*``), string parameter
defaults are substituted (``metric_prefix="data"`` books
``data.producer_wait``), and one level of in-module wrapper functions is
followed (``recovery._counter("recover.evicted")``) — then flags:

- a consumer selector/lookup naming a metric NO producer books;
- a ``ref_from="plan"`` drift rule whose metric's phase suffix is not a
  plan-priced phase (the predicted-breakdown mapping's keys) — the
  reference would silently be 0 instead of the plan's bound;
- a producer name booked in ``autodist_tpu_torch/`` package code but absent from
  ``docs/usage/observability.md``'s plane tables — the operator-facing
  contract the consoles and alert files are written against.

Consumer checks run only when the program books at least one producer (a
partial fixture tree is not a missing registry), and the docs check only
when observability.md exists under the repo root.
"""

import ast
import fnmatch
import re
from typing import Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (PACKAGE_PREFIX, Context, Finding,
                                              register_program)

_PRODUCER_FNS = {"counter", "gauge", "histogram", "span"}
_REG_TOKENS = {"reg", "registry", "metrics"}
_DOC_PATH = "docs/usage/observability.md"
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_*]+)+$")


def _name_pattern(arg, fn_defaults: Dict[str, str]) -> Optional[str]:
    """The (possibly wildcarded) metric name a call's first arg produces:
    a str constant verbatim; an f-string with constants kept, string
    parameter defaults substituted, and everything dynamic as ``*``."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id in fn_defaults:
                parts.append(fn_defaults[v.value.id])
            else:
                parts.append("*")
        pat = "".join(parts)
        while "**" in pat:
            pat = pat.replace("**", "*")
        return pat if pat.strip("*") else None
    return None


def _str_defaults(fn) -> Dict[str, str]:
    """``param -> default`` for a function's string-defaulted parameters."""
    out: Dict[str, str] = {}
    args = fn.args
    pos = args.posonlyargs + args.args
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(d, ast.Constant) and isinstance(d.value, str):
            out[a.arg] = d.value
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is not None and isinstance(d, ast.Constant) \
                and isinstance(d.value, str):
            out[a.arg] = d.value
    return out


def _param_forwarders(info, forwarded_arg) -> Dict[str, int]:
    """In-module functions that forward a parameter into a qualifying call
    -> the forwarded parameter's position. ``forwarded_arg(call)`` returns
    the candidate argument expression of a qualifying call (or None) —
    the ONE forwarding scanner both the producer-wrapper
    (``def _counter(name): return _metrics.counter(name)``) and the
    lookup-wrapper (``def _counter(reg, name): v = reg.get(name)``)
    harvests share, so the two kinds cannot drift."""
    out: Dict[str, int] = {}
    for name, fn in info.index.module_funcs.items():
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        for call in callgraph.calls_under(fn):
            arg = forwarded_arg(call)
            if arg is not None and isinstance(arg, ast.Name) \
                    and arg.id in params:
                out[name] = params.index(arg.id)
                break
    return out


def _producer_wrappers(info) -> Dict[str, int]:
    def forwarded(call):
        if callgraph.last_attr(call.func) in _PRODUCER_FNS and call.args:
            return call.args[0]
        return None

    return _param_forwarders(info, forwarded)


def _calls_with_defaults(node, defaults: Dict[str, str]):
    """Every Call node paired with its INNERMOST enclosing function's
    string-parameter defaults (so an f-string name substitutes the right
    scope's default exactly once)."""
    for child in callgraph.children(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _calls_with_defaults(child, _str_defaults(child))
            continue
        if isinstance(child, ast.Call):
            yield child, defaults
        yield from _calls_with_defaults(child, defaults)


def harvest_producers(program) -> Tuple[Dict[str, Tuple[str, int]],
                                        Dict[str, Tuple[str, int]]]:
    """``(exact, patterns)``: metric/span names the program books, each
    mapped to its first (path, line) booking site. Patterns contain ``*``."""
    exact: Dict[str, Tuple[str, int]] = {}
    patterns: Dict[str, Tuple[str, int]] = {}
    for info in program.modules():
        if info.relpath.startswith("tests/"):
            # Symmetric with the consumer-side exemption: a metric booked
            # only by a test fixture must not mask a production selector
            # gone dead (the very class GL009 exists to catch).
            continue
        wrappers = _producer_wrappers(info)
        for call, defaults in _calls_with_defaults(info.module.tree, {}):
            if not call.args:
                continue
            last = callgraph.last_attr(call.func)
            arg = None
            if last in _PRODUCER_FNS:
                arg = call.args[0]
            elif isinstance(call.func, ast.Name) and call.func.id in wrappers:
                pos = wrappers[call.func.id]
                if pos < len(call.args):
                    arg = call.args[pos]
            if arg is None:
                continue
            pat = _name_pattern(arg, defaults)
            if pat is None or not _NAME_RE.match(pat):
                continue
            site = (info.relpath, call.lineno)
            if "*" in pat:
                patterns.setdefault(pat, site)
            else:
                exact.setdefault(pat, site)
    return exact, patterns


def _booked(name: str, exact, patterns) -> bool:
    return name in exact or any(fnmatch.fnmatchcase(name, p)
                                for p in patterns)


def _prefix_bookable(prefix: str, exact, patterns) -> bool:
    """True when SOME booked name (or bookable pattern) can start with
    ``prefix`` — the ``selector.*`` fan-out case."""
    if any(n.startswith(prefix) for n in exact):
        return True
    for pat in patterns:
        head = pat.split("*", 1)[0]
        if head.startswith(prefix) or prefix.startswith(head):
            return True
    return False


def _alert_rule_dicts(tree):
    """Dict literals that look like alert rules: str-keyed with both a
    ``metric`` and a ``kind`` entry (the :class:`AlertRule` signature)."""
    for node in callgraph.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        fields: Dict[str, ast.AST] = {}
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                fields[k.value] = v
        if "metric" in fields and "kind" in fields:
            yield node, fields


def _plan_phases(program) -> Optional[Set[str]]:
    """The plan-priced phase vocabulary: keys of the dict literal mapping
    phases to ``breakdown.get("…")`` (``alerts.AlertRule._reference``).
    Harvested from NON-TEST modules only, like every other GL009 harvest —
    a test fixture must not become the phase vocabulary."""
    for info in program.modules():
        if info.relpath.startswith("tests/"):
            continue
        for node in callgraph.walk(info.module.tree):
            if not isinstance(node, ast.Dict) or not node.keys:
                continue
            keys: Set[str] = set()
            shape = True
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and isinstance(v, ast.Call)
                        and callgraph.last_attr(v.func) == "get"
                        and isinstance(v.func, ast.Attribute)
                        and callgraph.last_attr(v.func.value) == "breakdown"):
                    shape = False
                    break
                keys.add(k.value)
            if shape and keys:
                return keys
    return None


def _lookup_wrappers(info) -> Dict[str, int]:
    def forwarded(call):
        if callgraph.last_attr(call.func) == "get" \
                and isinstance(call.func, ast.Attribute) and call.args \
                and callgraph.name_tokens(
                    callgraph.last_attr(call.func.value)) & _REG_TOKENS:
            return call.args[0]
        return None

    return _param_forwarders(info, forwarded)


def _doc_wildcards(doc: str) -> List[str]:
    """Documented ``prefix.*`` wildcard families in the doc text."""
    return re.findall(r"[a-z][a-z0-9_.]*\.\*", doc)


def _documented(name: str, doc: str, wildcards: List[str]) -> bool:
    # Token-bounded, not substring: a booked `train.flops` must NOT count
    # as documented because `train.flops_per_s` appears in prose — that is
    # precisely the stragglers class the docs check exists to catch.
    if re.search(r"(?<![A-Za-z0-9_.*])" + re.escape(name)
                 + r"(?![A-Za-z0-9_*])", doc):
        return True
    head = name.split("*", 1)[0]
    for w in wildcards:
        wh = w[:-1]        # keep the trailing dot
        if head.startswith(wh) or (("*" in name) and wh.startswith(head)):
            return True
    return False


@register_program("GL009", "metric/event name not in the producer registry "
                           "or undocumented", full_program=True)
def check_metric_registry(program, ctx: Context) -> List[Finding]:
    """GL009 — metric/event-name registry (see the module docstring).

    The producer registry is generated from the program itself — every
    ``counter``/``gauge``/``histogram``/``span`` first-argument literal,
    with f-string sites contributing ``prefix.*`` patterns — so a metric is
    "registered" by being booked, never by being listed twice. Consumers
    (alert-rule ``metric`` selectors, registry ``.get("…")`` lookups in the
    consoles, ``ref_from="plan"`` phase suffixes) must resolve against it;
    producers in package code must appear in
    ``docs/usage/observability.md``. The class this kills: an alert
    rule whose selector could never match a booked value was shipped dead —
    the incident it existed to page on would have passed silently.
    """
    findings: List[Finding] = []
    exact, patterns = harvest_producers(program)
    if not exact and not patterns:
        return []
    phases = _plan_phases(program)

    for info in program.modules():
        module = info.module
        if module.relpath.startswith("tests/"):
            # A test's rule dict or lookup is a fixture exercising the
            # machinery, not a shipped selector; the selectors operators
            # depend on live in package/tool code.
            continue
        tree = module.tree
        # --- consumers: alert-rule selectors --------------------------------
        for node, fields in _alert_rule_dicts(tree):
            metric = fields["metric"]
            if not (isinstance(metric, ast.Constant)
                    and isinstance(metric.value, str)):
                continue
            sel = metric.value
            if sel.endswith(".*"):
                ok = _prefix_bookable(sel[:-1], exact, patterns)
            else:
                ok = _booked(sel, exact, patterns)
            if not ok:
                findings.append(Finding(
                    "GL009", module.relpath, node.lineno, node.col_offset,
                    f"alert-rule selector {sel!r} matches no metric any "
                    f"producer books; the rule is dead on arrival — it can "
                    f"never fire",
                    scope=module.scope_at(node)))
                continue
            ref_from = fields.get("ref_from")
            if phases is not None and isinstance(ref_from, ast.Constant) \
                    and ref_from.value == "plan" and not sel.endswith(".*"):
                phase = sel.rsplit(".", 1)[-1]
                if phase not in phases:
                    findings.append(Finding(
                        "GL009", module.relpath, node.lineno,
                        node.col_offset,
                        f"drift rule selects {sel!r} with ref_from='plan', "
                        f"but {phase!r} is not a plan-priced phase "
                        f"({', '.join(sorted(phases))}); the reference "
                        f"silently degrades to 0 instead of the plan's "
                        f"predicted bound",
                        scope=module.scope_at(node)))
        # --- consumers: registry field lookups ------------------------------
        wrappers = _lookup_wrappers(info)
        for call in callgraph.calls_under(tree):
            arg = None
            if callgraph.last_attr(call.func) == "get" \
                    and isinstance(call.func, ast.Attribute) and call.args:
                recv = callgraph.name_tokens(
                    callgraph.last_attr(call.func.value))
                if recv & _REG_TOKENS:
                    arg = call.args[0]
            elif isinstance(call.func, ast.Name) \
                    and call.func.id in wrappers:
                pos = wrappers[call.func.id]
                if pos < len(call.args):
                    arg = call.args[pos]
            if arg is None or not isinstance(arg, ast.Constant) \
                    or not isinstance(arg.value, str):
                continue
            name = arg.value
            if not _NAME_RE.match(name) or "*" in name:
                continue
            if not _booked(name, exact, patterns):
                findings.append(Finding(
                    "GL009", module.relpath, call.lineno, call.col_offset,
                    f"registry lookup reads {name!r} but no producer books "
                    f"it; the field can only ever be missing (a typo'd "
                    f"console/consumer selector fails silently)",
                    scope=module.scope_at(call)))

    # --- producers vs. the documented plane tables --------------------------
    doc = ctx.doc_text(_DOC_PATH)
    if doc is not None:
        wildcards = _doc_wildcards(doc)
        undocumented: List[Tuple[str, Tuple[str, int]]] = []
        for name, site in list(exact.items()) + list(patterns.items()):
            if site[0].startswith(PACKAGE_PREFIX) \
                    and not _documented(name, doc, wildcards):
                undocumented.append((name, site))
        for name, (path, line) in sorted(undocumented,
                                         key=lambda e: (e[1][0], e[1][1])):
            mod = program.info_for(path)
            findings.append(Finding(
                "GL009", path, line, 0,
                f"metric/span name {name!r} is booked here but absent from "
                f"{_DOC_PATH}'s plane tables; operators and alert files are "
                f"written against that catalog — document it (or the "
                f"family it belongs to)",
                scope=mod.module.scope_at(line) if mod else ""))
    return findings
