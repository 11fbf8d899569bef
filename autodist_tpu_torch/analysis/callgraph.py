"""Small intra-module AST call-graph utilities shared by the checks.

Scope here is one module: bare-name calls to module-level functions and
``self.x()`` calls to methods of the enclosing class — the building blocks.
Cross-module resolution (imports, ``module.f()`` chains, instance typing,
re-export chains) lives in :mod:`autodist_tpu_torch.analysis.program`, which
composes these utilities into the whole-program :class:`ProgramIndex` the
interprocedural checks (GL001/GL002/GL009-GL011) run on.
"""

import ast
from collections import deque
from typing import Dict, Iterator, List, Optional, Set, Tuple


def children(node) -> List[ast.AST]:
    """``ast.iter_child_nodes(node)`` as a list, memoized on the node: the
    checks walk the same trees many times, and the field iteration is most
    of a walk's cost. Trees are never mutated after parsing."""
    kids = node.__dict__.get("_graftlint_children")
    if kids is None:
        kids = list(ast.iter_child_nodes(node))
        node._graftlint_children = kids
    return kids


def walk(node) -> List[ast.AST]:
    """``walk(node)``'s nodes, in its order, memoized on the node."""
    nodes = node.__dict__.get("_graftlint_walk")
    if nodes is None:
        nodes = []
        todo = deque([node])
        while todo:
            n = todo.popleft()
            todo.extend(children(n))
            nodes.append(n)
        node._graftlint_walk = nodes
    return nodes


def dotted_name(node) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain; None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_attr(node) -> Optional[str]:
    """The final component of a Name/Attribute chain (``c`` of ``a.b.c``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def name_tokens(name: Optional[str]) -> Set[str]:
    """Lower-cased underscore tokens of an identifier (``_write_mutex`` ->
    {"write", "mutex"}). Token matching avoids substring traps ("block"
    contains "lock")."""
    if not name:
        return set()
    return {t for t in name.lower().split("_") if t}


class ModuleIndex:
    """Per-module map of callable definitions. Call RESOLUTION lives in
    :class:`~autodist_tpu_torch.analysis.program.ProgramIndex`, which consumes
    these maps — this class only indexes what one module defines."""

    def __init__(self, tree: ast.Module):
        self.module_funcs: Dict[str, ast.FunctionDef] = {}
        self.methods: Dict[Tuple[str, str], ast.FunctionDef] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods[(node.name, item.name)] = item


def calls_under(node) -> Iterator[ast.Call]:
    """Every Call node in ``node``'s subtree, in source order."""
    for sub in walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def innermost_function(tree: ast.Module, node) -> Optional[ast.FunctionDef]:
    """The innermost FunctionDef/AsyncFunctionDef whose span contains
    ``node``'s line, or None at module level — the shared scope lookup the
    program-level checks use for local-type inference. The per-module span
    index is built once and memoized ON the tree object (lifetime-correct:
    it dies with the tree), so each lookup is O(defs), not O(AST)."""
    spans = getattr(tree, "_graftlint_fn_spans", None)
    if spans is None:
        spans = [(fn.lineno, fn.end_lineno or fn.lineno, fn)
                 for fn in walk(tree)
                 if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]
        tree._graftlint_fn_spans = spans
    best = None
    line = node.lineno
    for start, end, fn in spans:
        if start <= line <= end and (best is None or start >= best.lineno):
            best = fn
    return best


def walk_executed(node) -> List[ast.AST]:
    """``ast.walk`` that does NOT descend into function/lambda bodies:
    code inside a ``def``/``lambda`` under a ``with lock:`` is *deferred* —
    it runs when the callback is called, not while the lock is held — so
    lock-holding analyses must skip it (the nested def gets analyzed in its
    own right by module-wide walks). Decorators and argument defaults DO
    execute in place and are walked. Applies to the start node too: to walk
    a function's own body, iterate its ``.body`` statements. The node list
    is memoized on ``node``."""
    nodes = node.__dict__.get("_graftlint_executed")
    if nodes is not None:
        return nodes
    nodes = []
    stack = [node]
    while stack:
        n = stack.pop()
        nodes.append(n)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(n.decorator_list)
            stack.extend(n.args.defaults)
            stack.extend(d for d in n.args.kw_defaults if d is not None)
            continue
        if isinstance(n, ast.Lambda):
            continue
        stack.extend(children(n))
    node._graftlint_executed = nodes
    return nodes


def calls_executed(node) -> Iterator[ast.Call]:
    """Call nodes that actually execute as part of ``node``'s own flow
    (see :func:`walk_executed`)."""
    for sub in walk_executed(node):
        if isinstance(sub, ast.Call):
            yield sub


# The intra-module reaching-call search that used to live here was
# superseded by the cross-module version in
# :meth:`autodist_tpu_torch.analysis.program.ProgramIndex.find_reaching_call` —
# one search, one set of semantics.
