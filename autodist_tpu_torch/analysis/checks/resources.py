"""GL010 — resource-close discipline for registered closeables.

The JAX package's history: six example call sites constructed prefetch feeds and
never closed them — each one a leaked producer thread parked on a bounded
queue, invisible until a box slowly fills with daemon threads (or a test
run wedges at interpreter exit). The close contracts already exist
(``PrefetchProducer.close`` is prompt and idempotent, ``DataLoader.close``
joins its ring, servers unbind their port); what was missing is anything
making call sites USE them.

GL010 finds the closeable classes itself: any class in the linted program
that defines a ``close`` method is closeable, and any function that RETURNS
a construction of a closeable (``prefetch_to_device`` ->
``PrefetchProducer``; ``device_prefetch`` -> ``prefetch_to_device``) is a
closeable factory — computed to a fixpoint, so the whole feed-factory chain
is covered without a hand-kept list. In package/example/tool code (tests
are exempt: a leaked thread there dies with the short-lived process and a
hang is loud), a local ``x = Closeable(...)`` must reach ``close()`` on all
paths:

- ``with Closeable(...) as x:`` / ``with x:`` / ``contextlib.closing(x)``
  — clean;
- ``x.close()`` inside a ``try/finally`` — clean;
- ``x`` escaping (returned, yielded, stored on an object/container, passed
  to a non-builtin call) — ownership transferred, not this site's job;
- ``x.close()`` only on the straight-line path — flagged: an exception
  between construction and close leaks the resource exactly when things are
  already going wrong;
- no close at all — flagged.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (PACKAGE_PREFIX, Context, Finding,
                                              register_program)

# Builtins that read/iterate a value without taking ownership of it —
# `next(feed)` must not count as the feed escaping.
_NON_OWNING_CALLS = {
    "next", "iter", "len", "bool", "str", "repr", "print", "id", "type",
    "isinstance", "hash", "format", "getattr", "hasattr", "enumerate"}

# The port keeps its examples and tools inside the package; root files
# (chip_smoke.py) are checked too.
_CHECKED_PREFIXES = (PACKAGE_PREFIX,)


def _checked_path(relpath: str) -> bool:
    return relpath.startswith(_CHECKED_PREFIXES) or "/" not in relpath


def closeable_classes(program) -> Dict[Tuple[str, str], ast.ClassDef]:
    """``(relpath, class name) -> ClassDef`` for classes defining close()."""
    out: Dict[Tuple[str, str], ast.ClassDef] = {}
    for info in program.modules():
        for name, cls in info.classes.items():
            if (name, "close") in info.index.methods:
                out[(info.relpath, name)] = cls
    return out


def closeable_factories(program, classes) -> Set[Tuple[str, str]]:
    """``(relpath, function name)`` for functions whose ``return`` is a
    construction of a closeable class or a call of another closeable
    factory — iterated to a fixpoint across the program."""
    factories: Set[Tuple[str, str]] = set()

    def returns_closeable(info, fn) -> bool:
        for node in callgraph.walk(fn):
            if not isinstance(node, ast.Return) \
                    or not isinstance(node.value, ast.Call):
                continue
            resolved = _resolve_construction(program, info, node.value,
                                             classes, factories)
            if resolved is not None:
                return True
        return False

    changed = True
    while changed:
        changed = False
        for info in program.modules():
            for name, fn in info.index.module_funcs.items():
                key = (info.relpath, name)
                if key not in factories and returns_closeable(info, fn):
                    factories.add(key)
                    changed = True
    return factories


def _resolve_construction(program, info, call: ast.Call, classes,
                          factories) -> Optional[str]:
    """The closeable class/factory name ``call`` constructs, or None."""
    dotted = callgraph.dotted_name(call.func)
    if dotted is None:
        return None
    hit = program.resolve_class(info, dotted)
    if hit is not None and (hit[0].relpath, hit[1].name) in classes:
        return hit[1].name
    resolved = program.resolve_call(info, call, None)
    if resolved is not None and resolved.cls is None \
            and (resolved.info.relpath, resolved.fn.name) in factories:
        return resolved.fn.name
    return None


def _scopes(tree):
    """(scope_body_owner, statements) for the module and every def."""
    yield tree, tree.body
    for node in callgraph.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def _name_used_in(node, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in callgraph.walk(node))


@register_program("GL010", "registered closeable never reaches close() "
                           "on all paths")
def check_resource_close(program, ctx: Context) -> List[Finding]:
    """GL010 — resource-close discipline (see the module docstring).

    A finding means a locally-constructed closeable (prefetch producer,
    loader, server, client, metrics history — anything with a ``close``
    method, or a factory chain ending in one) neither escapes this scope
    nor reliably reaches ``close()``: either it is never closed at all, or
    the close sits on the straight-line path only, where the first
    exception skips it — the "six leaked feeds" class. Fix with
    ``try/finally`` or a ``with`` block; when the leak is intentional
    (process-lifetime singleton), suppress with a reason.
    """
    findings: List[Finding] = []
    classes = closeable_classes(program)
    if not classes:
        return []
    factories = closeable_factories(program, classes)

    for info in program.modules():
        module = info.module
        if not _checked_path(module.relpath):
            continue
        # Class-attribute constructions (`class Owner: feed = Feed()`) are
        # the class's state, like `self.feed = ...` — ownership lives with
        # the instance lifecycle, not this scope; a deferred method close
        # would be invisible to the tracer anyway.
        class_level_assigns = {
            id(stmt) for cls in callgraph.walk(module.tree)
            if isinstance(cls, ast.ClassDef)
            for stmt in cls.body if isinstance(stmt, ast.Assign)}
        for scope_owner, body in _scopes(module.tree):
            # Constructions inside with-items are managed by the with.
            managed_calls: Set[int] = set()
            scope_nodes = [n for stmt in body
                           for n in callgraph.walk_executed(stmt)]
            for node in scope_nodes:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        for sub in callgraph.walk(item.context_expr):
                            managed_calls.add(id(sub))
            for node in scope_nodes:
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call) \
                        or id(node.value) in managed_calls \
                        or id(node) in class_level_assigns:
                    continue
                what = _resolve_construction(program, info, node.value,
                                             classes, factories)
                if what is None:
                    continue
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
                if len(targets) != len(node.targets) or not targets:
                    continue   # attribute/container target: ownership moves
                # Multi-target `a = b = Producer()`: closing through EITHER
                # alias is enough — take the best verdict across them.
                rank = {"clean": 0, "escapes": 1, "unprotected": 2,
                        "leak": 3}
                name, verdict = min(
                    ((t.id, _trace_usage(scope_owner, node, t.id))
                     for t in targets), key=lambda nv: rank[nv[1]])
                if verdict == "leak":
                    findings.append(Finding(
                        "GL010", module.relpath, node.lineno,
                        node.col_offset,
                        f"`{name}` ({what}) is constructed here but never "
                        f"closed on any path; a leaked producer "
                        f"thread/socket survives this scope (the "
                        f"leaked-feeds class) — close it in try/finally or "
                        f"use a with block",
                        scope=module.scope_at(node)))
                elif verdict == "unprotected":
                    findings.append(Finding(
                        "GL010", module.relpath, node.lineno,
                        node.col_offset,
                        f"`{name}` ({what}) is closed only on the "
                        f"straight-line path; an exception between "
                        f"construction and close() leaks it exactly when "
                        f"the run is already failing — move the close into "
                        f"try/finally or use a with block",
                        scope=module.scope_at(node)))
    return findings


def _trace_usage(scope_owner, assign: ast.Assign, name: str) -> str:
    """Classify how ``name`` fares AFTER ``assign`` in this scope:
    ``"clean"`` / ``"escapes"`` / ``"unprotected"`` / ``"leak"``.

    Only uses at/after the assignment line count: a ``with feed:`` or
    ``feed.close()`` belonging to an EARLIER binding of the same name must
    not mark a later unclosed rebinding clean (close-old-construct-new is
    a normal pattern and the new resource still needs its own close)."""
    closed_in_finally = False
    closed_anywhere = False
    body = getattr(scope_owner, "body", [])
    executed = [n for stmt in body
                for n in callgraph.walk_executed(stmt)]
    in_finally: Set[int] = set()
    for node in executed:
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in callgraph.walk(stmt):
                    in_finally.add(id(sub))
    # A `with feed:` / `feed.close()` inside a nested def is DEFERRED code
    # — it must not classify the construction as clean (the callback may
    # never run). But a callback CAPTURING the resource is an ownership
    # hand-off we cannot trace: escape, not leak.
    for node in executed:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not scope_owner \
                and _name_used_in(node, name):
            return "escapes"
    for node in executed:
        if getattr(node, "lineno", assign.lineno) < assign.lineno:
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return "clean"
                if isinstance(expr, ast.Call) \
                        and callgraph.last_attr(expr.func) == "closing" \
                        and _name_used_in(expr, name):
                    return "clean"
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)) \
                and node.value is not None \
                and _name_used_in(node.value, name):
            return "escapes"
        if isinstance(node, ast.Assign) and node is not assign \
                and _name_used_in(node.value, name):
            # self.x = feed / d[k] = feed / alias = feed — the VALUE hands
            # the resource to another owner (or another name): escapes.
            # (`r = feed.close()` lands here too — conservative, no
            # finding, which is the safe direction.)
            if not all(isinstance(t, ast.Name) and t.id == name
                       for t in node.targets):
                return "escapes"
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == name:
                if fn.attr == "close":
                    closed_anywhere = True
                    if id(node) in in_finally:
                        closed_in_finally = True
                continue   # feed.method() — receiver use, not an escape
            callee = callgraph.last_attr(fn)
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if _name_used_in(arg, name):
                    if callee in _NON_OWNING_CALLS:
                        break
                    return "escapes"
    if closed_in_finally:
        return "clean"
    if closed_anywhere:
        return "unprotected"
    return "leak"
