"""GL003 — a captured graph's outputs read after a later replay.

PyTorch's counterpart of reading a donated buffer. A CUDA graph's outputs
are fixed storage inside the graph's memory pool: every ``g.replay()``
writes the new step's values over them. A name that aliases those outputs
(``first = out``, ``losses.append(out)``, ``loss = out[0]``) still looks
alive in Python after the next replay, but it now holds the later step's
values — no error, just wrong numbers. ``runner._CapturedBlock.replay``
clones the outputs after every replay for this reason; this check flags
the alias that skips the clone.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import Context, Finding, Module, register

# Calls that copy out of the graph's pool: after one, the value no longer
# aliases the outputs.
_COPY_TOKENS = {"clone", "copy", "deepcopy", "cpu", "tolist", "item"}
_CONTAINER_ADDS = {"append", "extend", "insert", "add"}


def _scopes(tree: ast.Module):
    yield tree
    for node in callgraph.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _walk_scope(scope):
    starts = scope.body \
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        else [scope]
    for start in starts:
        yield from callgraph.walk_executed(start)


def _graph_arg(item: ast.withitem) -> Optional[str]:
    expr = item.context_expr
    if isinstance(expr, ast.Call) \
            and (callgraph.dotted_name(expr.func) or "").endswith("cuda.graph") \
            and expr.args:
        return callgraph.dotted_name(expr.args[0])
    return None


def _copies(expr) -> bool:
    for node in callgraph.walk(expr):
        if isinstance(node, ast.Call) and callgraph.name_tokens(
                callgraph.last_attr(node.func)) & _COPY_TOKENS:
            return True
    return False


def _refs(expr, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               and isinstance(n.ctx, ast.Load) for n in callgraph.walk(expr))


def _loops(scope) -> List[ast.AST]:
    return [n for n in _walk_scope(scope) if isinstance(n, (ast.For, ast.While))]


def _inside(node, loop) -> bool:
    return loop.lineno <= node.lineno <= (loop.end_lineno or loop.lineno)


@register("GL003", "captured graph output read after a later replay")
def check_graph_output_reuse(module: Module, ctx: Context) -> List[Finding]:
    """GL003 — use of a captured graph's outputs after a later replay.

    Within one function (or module) scope: names bound inside a ``with
    torch.cuda.graph(g):`` block are ``g``'s outputs. An alias of them taken
    without a copy (``a = out``, ``a = out[0]``, ``xs.append(out)``; a
    ``clone``/``copy``/``cpu``/``tolist``/``item`` call in the value is a
    copy) is stale once ``g.replay()`` runs after it — later in the scope,
    or anywhere in a loop that also takes the alias. A read of the alias
    after that replay, before the alias is rebound, is flagged: it sees the
    later step's values. Reading ``out`` itself after a replay is the
    intended use and is not flagged.

    Only same-scope flows through plain names are tracked, as the JAX
    package's use-after-donate check tracks only the direct pattern: the
    check is a tripwire, not an escape analysis.
    """
    if module.tree is None or "cuda.graph" not in module.source:
        return []
    findings: List[Finding] = []
    for scope in _scopes(module.tree):
        outputs: Dict[str, Set[str]] = {}     # graph -> output names
        for node in _walk_scope(scope):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                graph = _graph_arg(item)
                if graph is None:
                    continue
                names = outputs.setdefault(graph, set())
                for stmt in node.body:
                    for sub in callgraph.walk_executed(stmt):
                        if isinstance(sub, ast.Name) \
                                and isinstance(sub.ctx, ast.Store):
                            names.add(sub.id)
        if not outputs:
            continue
        replays: Dict[str, List[ast.Call]] = {}
        for node in _walk_scope(scope):
            if isinstance(node, ast.Call) \
                    and callgraph.last_attr(node.func) == "replay" \
                    and isinstance(node.func, ast.Attribute):
                g = callgraph.dotted_name(node.func.value)
                if g in outputs:
                    replays.setdefault(g, []).append(node)
        loops = _loops(scope)
        for graph, outs in outputs.items():
            # alias events: (alias name, line, node)
            events: List[Tuple[str, int, ast.AST]] = []
            for node in _walk_scope(scope):
                if isinstance(node, ast.Assign) and _refs(node.value, outs) \
                        and not _copies(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in outs:
                            events.append((t.id, node.lineno, node))
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _CONTAINER_ADDS \
                        and isinstance(node.func.value, ast.Name) \
                        and any(_refs(a, outs) and not _copies(a)
                                for a in node.args):
                    events.append((node.func.value.id, node.lineno, node))
            for alias, line, node in events:
                stale = [r.lineno for r in replays.get(graph, ())
                         if r.lineno > line]
                for loop in loops:
                    if _inside(node, loop) and any(
                            _inside(r, loop) for r in replays.get(graph, ())):
                        stale.append(loop.end_lineno or loop.lineno)
                if not stale:
                    continue
                after = min(stale)
                rebind = min((n.lineno for n in _walk_scope(scope)
                              if isinstance(n, ast.Name) and n.id == alias
                              and isinstance(n.ctx, ast.Store)
                              and n.lineno > line), default=None)
                if rebind is not None and rebind <= after:
                    continue   # rebound before the replay: no longer an alias
                for n in _walk_scope(scope):
                    if isinstance(n, ast.Name) and n.id == alias \
                            and isinstance(n.ctx, ast.Load) \
                            and n.lineno > after \
                            and (rebind is None or n.lineno < rebind):
                        findings.append(Finding(
                            "GL003", module.relpath, n.lineno, n.col_offset,
                            f"`{alias}` aliases the outputs of graph "
                            f"`{graph}` and is read after a later "
                            f"`{graph}.replay()`, which overwrote them; "
                            f"clone the outputs before the next replay",
                            scope=module.scope_at(n)))
                        break   # one finding per alias event
    return findings
