"""GL004 — host effects and host syncs inside a CUDA-graph capture or a
``make_fx`` trace.

PyTorch's counterpart of JAX's trace-time freeze. A ``with
torch.cuda.graph(g):`` body runs ONCE, at capture; every later
``g.replay()`` re-launches only the recorded kernels. Host-side code inside
the capture therefore either runs once where the author meant every step (a
``print``, a ``time.perf_counter()`` reading, a ``random`` draw, a counter
kept on ``self``) or breaks the capture outright: a host read of a device
tensor (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``) or a
synchronize is illegal while a stream captures. A function handed to
``make_fx`` is the same hazard: it runs once, on fake tensors, to build a
graph, and its host effects are not in that graph.
"""

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import Context, Finding, Module, register

_IMPURE_EXACT = {"print", "input", "breakpoint", "open"}
_IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.")
# Host reads of a device tensor, and synchronizes: each waits for the card,
# which a capturing stream refuses.
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_FOLLOW_DEPTH = 4   # in-module call hops followed from a capture body


def _is_graph_ctx(expr) -> bool:
    """``torch.cuda.graph(...)`` (any import spelling ending in
    ``cuda.graph`` or a bare ``graph`` imported from ``torch.cuda``)."""
    if not isinstance(expr, ast.Call):
        return False
    name = callgraph.dotted_name(expr.func) or ""
    return name.endswith("cuda.graph")


def _make_fx_targets(tree: ast.Module) -> Set[str]:
    """Names of defs handed to ``make_fx(f, ...)``."""
    out: Set[str] = set()
    for node in callgraph.walk(tree):
        if isinstance(node, ast.Call) \
                and callgraph.last_attr(node.func) == "make_fx" \
                and node.args and isinstance(node.args[0], ast.Name):
            out.add(node.args[0].id)
    return out


def _bound_names(nodes) -> Set[str]:
    """Names the region binds itself: its locals (and nested defs) — stores
    onto those are the region's own objects, not captured ones."""
    bound: Set[str] = set()
    for top in nodes:
        for node in callgraph.walk(top):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(node.name)
    return bound


def _region_nodes(stmts) -> Iterator[ast.AST]:
    for stmt in stmts:
        yield from callgraph.walk_executed(stmt)


def _enclosing_class(module: Module, index, node) -> Optional[str]:
    scope = module.scope_at(node)
    head = scope.split(".")[0] if scope else ""
    if any(cls == head for cls, _ in index.methods):
        return head
    return None


def _callees(index, stmts, cls: Optional[str]) -> List[Tuple[ast.AST, str]]:
    """In-module defs a region calls: bare names of module functions and
    ``self.m()`` methods of the enclosing class."""
    out = []
    for call in (c for c in _region_nodes(stmts) if isinstance(c, ast.Call)):
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in index.module_funcs:
            out.append((index.module_funcs[fn.id], None))
        elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and fn.value.id == "self" and cls is not None \
                and (cls, fn.attr) in index.methods:
            out.append((index.methods[(cls, fn.attr)], cls))
    return out


def _region_findings(module: Module, stmts, params: Set[str], what: str,
                     seen: Set[Tuple[int, int]]) -> List[Finding]:
    findings: List[Finding] = []
    bound = _bound_names(stmts) - params

    def add(node, msg):
        key = (node.lineno, node.col_offset)
        if key not in seen:
            seen.add(key)
            findings.append(Finding("GL004", module.relpath, node.lineno,
                                    node.col_offset, msg,
                                    scope=module.scope_at(node)))

    for node in _region_nodes(stmts):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            add(node, f"`{kind} {', '.join(node.names)}` inside {what}: "
                      f"the outer-scope write happens once, when the "
                      f"graph is built, not on every replay")
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Attribute):
                    continue
                root = t
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id not in bound:
                    add(node, f"{what} stores onto captured object "
                              f"`{callgraph.dotted_name(t)}`: the store "
                              f"runs once, when the graph is built, and no "
                              f"replay repeats it")
        elif isinstance(node, ast.Call):
            name = callgraph.dotted_name(node.func) or ""
            last = callgraph.last_attr(node.func)
            if name in _IMPURE_EXACT or name.startswith(_IMPURE_PREFIXES):
                add(node, f"host call `{name}` inside {what} runs once, "
                          f"when the graph is built, not on every replay")
            elif isinstance(node.func, ast.Attribute) \
                    and last in _SYNC_ATTRS:
                add(node, f"host sync `{name or last}` inside {what}: a "
                          f"capturing stream refuses it, and a trace reads "
                          f"a fake value once")
    return findings


def _params(fn) -> Set[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


@register("GL004", "host effect / host sync inside a CUDA-graph capture or "
                   "a make_fx trace")
def check_capture_effects(module: Module, ctx: Context) -> List[Finding]:
    """GL004 — host effects under capture.

    Inside a ``with torch.cuda.graph(...)`` block (and the module functions
    and ``self`` methods it calls, a few hops deep), or inside a def handed
    to ``make_fx(f, ...)``, flags:

    - ``global``/``nonlocal`` declarations, and attribute stores onto
      objects the region did not create (``self.steps += 1``): they happen
      once, at capture, and no replay repeats them;
    - host-effect calls (``print``, ``time.*``, ``random.*``,
      ``np.random.*``, ``open``): their value or effect is frozen at capture;
    - host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
      ``.synchronize()``): illegal while a stream captures, and a fake value
      under ``make_fx``.

    Keep capture bodies pure device work; count, time and log outside the
    ``with`` (``runner._capture`` books its launches from outside the
    graph, and ``_CapturedBlock.replay`` advances the step on the host).
    """
    if module.tree is None or ("cuda.graph" not in module.source
                               and "make_fx" not in module.source):
        return []
    findings: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()
    index = callgraph.ModuleIndex(module.tree)

    for node in callgraph.walk(module.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)) \
                or not any(_is_graph_ctx(i.context_expr) for i in node.items):
            continue
        what = "a CUDA-graph capture"
        findings.extend(_region_findings(module, node.body, set(), what, seen))
        cls = _enclosing_class(module, index, node)
        frontier = _callees(index, node.body, cls)
        visited: Set[int] = set()
        for _ in range(_FOLLOW_DEPTH):
            nxt = []
            for fn, fcls in frontier:
                if id(fn) in visited:
                    continue
                visited.add(id(fn))
                findings.extend(_region_findings(
                    module, fn.body, _params(fn),
                    f"`{fn.name}`, called under a CUDA-graph capture", seen))
                nxt.extend(_callees(index, fn.body, fcls))
            frontier = nxt

    targets = _make_fx_targets(module.tree)
    if targets:
        for fn in callgraph.walk(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name in targets:
                findings.extend(_region_findings(
                    module, fn.body, _params(fn),
                    f"`{fn.name}`, traced by make_fx", seen))
    return findings
