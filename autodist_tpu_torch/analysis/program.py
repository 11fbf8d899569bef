"""Whole-program call graph: import-resolving, bounded, deterministic.

:mod:`autodist_tpu_torch.analysis.callgraph` deliberately stops at the module
boundary — which was graftlint's documented blind spot: a ``with lock:`` body
that reaches ``runner.run`` or a socket send *through another module* passed
lint, and the last PRs' review logs show exactly that class of bug (leaked
producer threads at example call sites, a retry replaying a non-idempotent
op defined two modules away). :class:`ProgramIndex` lifts resolution to the
whole linted file set:

- **module naming** — every linted file gets a dotted module name derived
  from its repo-relative path (``autodist_tpu_torch/data/prefetch.py`` ->
  ``autodist_tpu_torch.data.prefetch``; ``pkg/__init__.py`` -> ``pkg``), so import
  statements can be resolved against the linted set itself. Files outside
  the set simply do not resolve — the graph is closed over what was linted.
- **import resolution** — ``import a.b [as c]``, ``from a.b import f [as g]``
  and relative ``from . import x`` forms map local names to (module, symbol)
  pairs; ``module.f()`` attribute chains resolve by longest-module-prefix.
- **instance typing** — ``x = Ctor(...)`` (local) and ``self._x = Ctor(...)``
  (instance attribute, harvested per class) bind names to classes when the
  constructor statically resolves, so ``x.m()`` / ``self._x.m()`` reach the
  method body — including across modules.
- **bounded reaching-call search** — :meth:`ProgramIndex.find_reaching_call`
  is the cross-module version of ``callgraph.find_reaching_call``:
  BFS through resolvable calls, cycle-safe, depth-limited
  (:data:`MAX_DEPTH` hops), walking only *executed* code
  (``callgraph.walk_executed`` — deferred callbacks stay deferred).

Everything here is a static over-approximation in the safe direction for
lint: unresolvable calls (dynamic dispatch, higher-order) terminate the
search rather than guessing. Resolution order is source order, so results
are deterministic for a given file set.
"""

import ast
from typing import Callable, Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph

MAX_DEPTH = 8   # cross-module hop bound for reaching-call searches


def module_dotted_name(relpath: str) -> str:
    """Dotted module name for a repo-relative ``.py`` path.
    ``a/b/c.py`` -> ``a.b.c``; ``a/b/__init__.py`` -> ``a.b``. Leading
    ``..`` components (a path linted from OUTSIDE the root — the CLI run
    against a fixture tree) are dropped; :class:`ProgramIndex` additionally
    registers suffix aliases for those so their intra-tree imports still
    resolve."""
    rel = relpath.replace("\\", "/")
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    elif rel == "__init__":
        rel = ""
    parts = [p for p in rel.split("/") if p not in ("..", ".", "")]
    return ".".join(parts)


class ModuleInfo:
    """Per-module resolution facts: defs, classes, and the import table."""

    def __init__(self, module):
        self.module = module                      # core.Module
        self.relpath: str = module.relpath
        self.dotted = module_dotted_name(module.relpath)
        tree = module.tree
        self.index = callgraph.ModuleIndex(tree) if tree is not None \
            else callgraph.ModuleIndex(ast.parse(""))
        self.classes: Dict[str, ast.ClassDef] = {}
        # local alias -> dotted module name ("import a.b as c")
        self.import_mod: Dict[str, str] = {}
        # local name -> (dotted module, symbol) ("from a.b import f as g")
        self.import_sym: Dict[str, Tuple[str, str]] = {}
        if tree is None:
            return
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
        package = self.dotted.rsplit(".", 1)[0] if "." in self.dotted else ""
        if self.relpath.endswith("__init__.py"):
            package = self.dotted
        # Walk the WHOLE tree: this codebase uses function-level imports
        # (lazy torch / tool imports) routinely, and they bind names that the
        # checks' call sites use.
        for node in callgraph.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    self.import_mod[local] = target
                    if alias.asname is None and "." in alias.name:
                        # "import a.b.c" binds "a"; remember the full chain
                        # too so "a.b.c.f" resolves by prefix.
                        self.import_mod.setdefault(alias.name, alias.name)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # Relative import: climb from this module's package.
                    parts = package.split(".") if package else []
                    climb = node.level - 1
                    if climb and climb <= len(parts):
                        parts = parts[:-climb]
                    elif climb:
                        parts = []
                    base = ".".join(parts + ([base] if base else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.import_sym[local] = (base, alias.name)


class Resolved:
    """One resolved callable: its module, def node, and owning class name."""

    __slots__ = ("info", "fn", "cls")

    def __init__(self, info: ModuleInfo, fn, cls: Optional[str]):
        self.info = info
        self.fn = fn
        self.cls = cls


class ProgramIndex:
    """Cross-module call resolution over a set of parsed modules."""

    def __init__(self, modules: Dict[str, object]):
        """``modules``: relpath -> ``core.Module`` (parse errors excluded)."""
        self.infos: Dict[str, ModuleInfo] = {
            rel: ModuleInfo(mod) for rel, mod in sorted(modules.items())
            if mod.tree is not None}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        for rel in sorted(self.infos):
            info = self.infos[rel]
            if info.dotted:
                self.by_dotted.setdefault(info.dotted, info)
        # Out-of-tree modules (relpath escaping the root — the CLI linting
        # a fixture dir) also register their dotted-name SUFFIXES, so
        # `from pkg.sender import push` in /tmp/fixture/pkg resolves even
        # though the full dotted name is prefixed with the escape path.
        # In-root modules never get suffix aliases: the repo gate's
        # resolution stays exact. setdefault over sorted paths keeps
        # collisions deterministic (first path wins).
        for rel in sorted(self.infos):
            info = self.infos[rel]
            if rel.startswith("..") and info.dotted:
                parts = info.dotted.split(".")
                for i in range(1, len(parts)):
                    self.by_dotted.setdefault(".".join(parts[i:]), info)
        self._local_types_cache: Dict[int, Dict[str, Tuple[ModuleInfo, str]]] = {}
        self._attr_types_cache: Dict[Tuple[str, str],
                                     Dict[str, Tuple[ModuleInfo, str]]] = {}

    # ------------------------------------------------------------ module maps
    def modules(self) -> List[ModuleInfo]:
        return [self.infos[k] for k in sorted(self.infos)]

    def info_for(self, relpath: str) -> Optional[ModuleInfo]:
        return self.infos.get(relpath)

    def _split_module_prefix(self, dotted: str) \
            -> Optional[Tuple[ModuleInfo, List[str]]]:
        """Longest known-module prefix of ``dotted`` + the remainder parts."""
        parts = dotted.split(".")
        for cut in range(len(parts), 0, -1):
            info = self.by_dotted.get(".".join(parts[:cut]))
            if info is not None:
                return info, parts[cut:]
        return None

    # ------------------------------------------------------- class resolution
    def _follow_reexport(self, info: ModuleInfo, symbol: str, hops: int = 3) \
            -> Optional[Tuple[ModuleInfo, str]]:
        """Chase ``from .x import Sym`` re-export chains (package
        ``__init__.py`` surfaces) to the module that DEFINES ``symbol``."""
        while hops > 0:
            if symbol in info.classes \
                    or symbol in info.index.module_funcs:
                return info, symbol
            sym = info.import_sym.get(symbol)
            if sym is None:
                return None
            target = self.by_dotted.get(sym[0])
            if target is None:
                return None
            info, symbol = target, sym[1]
            hops -= 1
        return None

    def resolve_class(self, info: ModuleInfo, name: str) \
            -> Optional[Tuple[ModuleInfo, ast.ClassDef]]:
        """The ClassDef a (possibly dotted) name refers to from ``info``
        (following package re-export chains)."""
        if "." not in name:
            hit = self._follow_reexport(info, name)
            if hit is not None and hit[1] in hit[0].classes:
                return hit[0], hit[0].classes[hit[1]]
            return None
        head, _, rest = name.partition(".")
        base = info.import_mod.get(head)
        if base is None:
            sym = info.import_sym.get(head)
            if sym is not None:
                base = f"{sym[0]}.{sym[1]}" if sym[0] else sym[1]
        if base is None:
            return None
        hit = self._split_module_prefix(f"{base}.{rest}")
        if hit is None:
            return None
        target, remainder = hit
        if len(remainder) == 1:
            deep = self._follow_reexport(target, remainder[0])
            if deep is not None and deep[1] in deep[0].classes:
                return deep[0], deep[0].classes[deep[1]]
        return None

    def class_method(self, info: ModuleInfo, cls_name: str, method: str) \
            -> Optional[Resolved]:
        hit = self.resolve_class(info, cls_name) if "." in cls_name \
            else ((info, info.classes[cls_name]) if cls_name in info.classes
                  else self.resolve_class(info, cls_name))
        if hit is None:
            return None
        owner, cls = hit
        fn = owner.index.methods.get((cls.name, method))
        return Resolved(owner, fn, cls.name) if fn is not None else None

    # ---------------------------------------------------- instance-type facts
    def local_types(self, info: ModuleInfo, scope_node) \
            -> Dict[str, Tuple[ModuleInfo, str]]:
        """``name -> (owner module, class name)`` for ``x = Ctor(...)``
        assignments executed in ``scope_node``'s own flow."""
        cached = self._local_types_cache.get(id(scope_node))
        if cached is not None:
            return cached
        types: Dict[str, Tuple[ModuleInfo, str]] = {}
        body = getattr(scope_node, "body", None) or []
        for stmt in body:
            for node in callgraph.walk_executed(stmt):
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call):
                    continue
                ctor = callgraph.dotted_name(node.value.func)
                if ctor is None:
                    continue
                hit = self.resolve_class(info, ctor)
                if hit is None:
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        types[target.id] = (hit[0], hit[1].name)
        self._local_types_cache[id(scope_node)] = types
        return types

    def attr_types(self, info: ModuleInfo, cls_name: str) \
            -> Dict[str, Tuple[ModuleInfo, str]]:
        """``attr -> (owner module, class name)`` for ``self.attr = Ctor()``
        assignments anywhere in class ``cls_name``'s methods."""
        key = (info.relpath, cls_name)
        cached = self._attr_types_cache.get(key)
        if cached is not None:
            return cached
        types: Dict[str, Tuple[ModuleInfo, str]] = {}
        cls = info.classes.get(cls_name)
        if cls is not None:
            for node in callgraph.walk(cls):
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call):
                    continue
                ctor = callgraph.dotted_name(node.value.func)
                if ctor is None:
                    continue
                hit = self.resolve_class(info, ctor)
                if hit is None:
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Attribute) \
                            and isinstance(target.value, ast.Name) \
                            and target.value.id == "self":
                        types[target.attr] = (hit[0], hit[1].name)
        self._attr_types_cache[key] = types
        return types

    # -------------------------------------------------------- call resolution
    def resolve_call(self, info: ModuleInfo, call: ast.Call,
                     current_class: Optional[str],
                     local_types: Optional[Dict] = None) -> Optional[Resolved]:
        """The def a call statically lands in, across modules, or None."""
        func = call.func
        local_types = local_types or {}
        if isinstance(func, ast.Name):
            name = func.id
            fn = info.index.module_funcs.get(name)
            if fn is not None:
                return Resolved(info, fn, None)
            hit = self.resolve_class(info, name)
            if hit is not None:    # constructor: __init__ executes in place
                owner, cls = hit
                init = owner.index.methods.get((cls.name, "__init__"))
                if init is not None:
                    return Resolved(owner, init, cls.name)
                return None
            deep = self._follow_reexport(info, name)
            if deep is not None:
                fn = deep[0].index.module_funcs.get(deep[1])
                if fn is not None:
                    return Resolved(deep[0], fn, None)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        # self.m() / cls.m()
        if isinstance(func.value, ast.Name) \
                and func.value.id in ("self", "cls") and current_class:
            fn = info.index.methods.get((current_class, func.attr))
            if fn is not None:
                return Resolved(info, fn, current_class)
            return None
        # self._attr.m() — instance-attribute typing
        if isinstance(func.value, ast.Attribute) \
                and isinstance(func.value.value, ast.Name) \
                and func.value.value.id == "self" and current_class:
            typed = self.attr_types(info, current_class).get(func.value.attr)
            if typed is not None:
                owner, cls_name = typed
                fn = owner.index.methods.get((cls_name, func.attr))
                if fn is not None:
                    return Resolved(owner, fn, cls_name)
            return None
        # obj.m() on a locally-constructed instance
        if isinstance(func.value, ast.Name):
            typed = local_types.get(func.value.id)
            if typed is not None:
                owner, cls_name = typed
                fn = owner.index.methods.get((cls_name, func.attr))
                if fn is not None:
                    return Resolved(owner, fn, cls_name)
        # module.f() / pkg.mod.f() / pkg.mod.Cls(...) attribute chains
        dotted = callgraph.dotted_name(func)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        base = info.import_mod.get(head)
        if base is None:
            sym = info.import_sym.get(head)
            if sym is not None and sym[0]:
                base = f"{sym[0]}.{sym[1]}"
        if base is None or not rest:
            return None
        hit = self._split_module_prefix(f"{base}.{rest}")
        if hit is None:
            return None
        target, remainder = hit
        if len(remainder) == 1:
            deep = self._follow_reexport(target, remainder[0])
            if deep is not None:
                target, symbol = deep
                fn = target.index.module_funcs.get(symbol)
                if fn is not None:
                    return Resolved(target, fn, None)
                cls = target.classes.get(symbol)
                if cls is not None:
                    init = target.index.methods.get((cls.name, "__init__"))
                    if init is not None:
                        return Resolved(target, init, cls.name)
        elif len(remainder) == 2:
            fn = target.index.methods.get((remainder[0], remainder[1]))
            if fn is not None:
                return Resolved(target, fn, remainder[0])
        return None

    # ------------------------------------------------- reaching-call search
    def find_reaching_call(
            self, info: ModuleInfo, start_nodes: List[ast.AST],
            current_class: Optional[str], scope_node,
            predicate: Callable[[ast.Call, ModuleInfo], Optional[str]],
            max_depth: int = MAX_DEPTH) \
            -> Optional[Tuple[ast.Call, str, List[str]]]:
        """Cross-module BFS from ``start_nodes`` for the first call where
        ``predicate(call, module_info)`` returns a label. Returns
        ``(top_level_call, label, hop_path)`` — ``hop_path`` names each
        module-qualified hop for the finding message. Depth- and
        cycle-bounded; deterministic (source order)."""
        local = self.local_types(info, scope_node) \
            if scope_node is not None else {}
        for top in start_nodes:
            for call in callgraph.calls_executed(top):
                hit = self._search(info, call, current_class, local,
                                   predicate, max_depth, visited={})
                if hit is not None:
                    label, path = hit
                    return call, label, path
        return None

    def _search(self, info: ModuleInfo, call: ast.Call,
                current_class: Optional[str], local_types: Dict,
                predicate, depth: int,
                visited: Dict[Tuple[str, int], int]):
        label = predicate(call, info)
        name = callgraph.dotted_name(call.func) or "<dynamic>"
        if label is not None:
            return label, [name]
        if depth <= 0:
            return None
        resolved = self.resolve_call(info, call, current_class, local_types)
        if resolved is None:
            return None
        key = (resolved.info.relpath, id(resolved.fn))
        # Depth-aware cycle guard: a callee first reached near the depth
        # limit was only SHALLOWLY explored — re-reaching it with more
        # budget must re-explore, or a blocking call a few hops inside it
        # goes unseen depending on statement order. Skip only when the
        # previous visit had at least this much depth left.
        if visited.get(key, -1) >= depth:
            return None
        visited[key] = depth
        callee_local = self.local_types(resolved.info, resolved.fn)
        hop = name if resolved.info is info \
            else f"{resolved.info.dotted or resolved.info.relpath}.{resolved.fn.name}"
        for stmt in resolved.fn.body:
            for inner in callgraph.calls_executed(stmt):
                hit = self._search(resolved.info, inner, resolved.cls,
                                   callee_local, predicate, depth - 1,
                                   visited)
                if hit is not None:
                    inner_label, path = hit
                    return inner_label, [hop] + path
        return None
