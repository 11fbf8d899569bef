"""GL012 guarded-field consistency — the static half of the race detector.

The classic lockset argument, scoped the way GL010 scopes closeables:
DISCOVERED from the code, never listed. For every class in the checked tree,
each instance attribute's guard is *inferred* from the writes that happen
inside ``with self._lock:`` (or ``with rep._lock:`` — any receiver whose
type resolves) blocks; an attribute the code bothers to guard in one method
but reads or writes bare in another method that can run on a different
thread is a finding. "Can run on a different thread" means: the bare access
(or the guarded write) sits in a method reachable from a thread entry point
— ``Thread(target=self.m)`` anywhere in the class family — or the access
crosses a class boundary through a typed receiver (a ``Replica`` attribute
touched from ``Router`` methods is shared state by construction; the writer
taking a lock is the admission that it races).

What keeps the false-positive rate workable:

- **single-guard inference**: an attribute is only checked when ALL its
  guarded writes agree on one lock attribute; ambiguous disciplines are
  skipped, not guessed.
- **locked helpers**: a method whose every intra-family call site sits
  under a guard (``_inflight_locked`` called only from ``with self._lock``
  blocks) has its accesses credited with that guard — the
  lock-held-helper idiom this codebase uses deliberately.
- **class families**: base classes resolvable through the ProgramIndex are
  folded in, so a scheduling loop defined on ``_BatcherBase`` makes the
  subclass's methods thread-reachable and the base's ``with self._lock:``
  call sites guard the subclass's hooks.
- **deferred code is skipped** (``callgraph.walk_executed`` semantics): a
  closure body under a ``with`` is not guarded by it, and is not walked.
- ``__init__`` self-writes are construction, not publication; attributes
  holding synchronization objects themselves (locks, conditions, events,
  queues, threads) are exempt — they are the discipline, not the data.

Like every program check its results are never file-cached (two-layer cache
semantics); suppression needs the mandatory reason
(``# graftlint: disable=GL012(why the bare access is safe)``).
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (PACKAGE_PREFIX, Context, Finding,
                                              register_program)
from autodist_tpu_torch.analysis.checks.concurrency import (_LOCK_CTORS,
                                                      _LOCK_TOKENS)

# Constructors whose instances are internally synchronized (or are the
# synchronization): attributes bound to them are exempt from the guarded-
# field rule. The san_* factories are the sanitizer's lock-producing twins.
_SYNC_CTORS = _LOCK_CTORS | {
    "Event", "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "BoundedQueue", "deque", "count", "local", "Thread",
    "san_lock", "san_rlock", "san_condition", "san_event",
}
_LOCKY_CTORS = _LOCK_CTORS | {"san_lock", "san_rlock", "san_condition"}

# The port keeps its examples and tools inside the package; root files
# (chip_smoke.py) are checked too.
_CHECKED_PREFIXES = (PACKAGE_PREFIX,)


def _checked_path(relpath: str) -> bool:
    return relpath.startswith(_CHECKED_PREFIXES) or "/" not in relpath


_LIST_HEADS = {"List", "list", "Sequence", "Iterable", "Iterator", "Tuple",
               "tuple", "Set", "set", "FrozenSet", "frozenset"}


def _annotation_class(ann) -> Optional[Tuple[str, bool]]:
    """``(class name, is_element_type)`` for an annotation that names one
    class — ``C``, ``"C"``, ``Optional[C]`` -> (C, False); ``List[C]`` and
    friends -> (C, True); anything else None."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        name = callgraph.dotted_name(ann)
        return (name, False) if name else None
    if isinstance(ann, ast.Subscript):
        head = callgraph.last_attr(ann.value)
        inner = ann.slice
        if head == "Optional":
            hit = _annotation_class(inner)
            return (hit[0], False) if hit and not hit[1] else None
        if head in _LIST_HEADS:
            if isinstance(inner, ast.Tuple) and inner.elts:
                inner = inner.elts[0]
            hit = _annotation_class(inner)
            return (hit[0], True) if hit and not hit[1] else None
    return None


class _ClassFacts:
    """Per-class harvest: lock attrs, sync-object attrs, thread entries."""

    def __init__(self):
        self.lock_attrs: Set[str] = set()     # self.X = Lock()/san_lock()...
        self.sync_attrs: Set[str] = set()     # exempt attribute names
        self.entries: Set[str] = set()        # Thread(target=self.m) methods
        self.bases: List[str] = []            # base-class dotted names
        self.methods: Dict[str, ast.FunctionDef] = {}


class _Access:
    __slots__ = ("attr", "cls_key", "is_write", "guards", "relpath", "line",
                 "col", "scope", "method_key", "cross_class", "in_init")

    def __init__(self, attr, cls_key, is_write, guards, relpath, line, col,
                 scope, method_key, cross_class, in_init):
        self.attr = attr              # attribute name
        self.cls_key = cls_key        # (owner relpath, class name)
        self.is_write = is_write
        self.guards = guards          # frozenset of lock-attr names held
        self.relpath = relpath        # module containing the ACCESS
        self.line = line
        self.col = col
        self.scope = scope
        self.method_key = method_key  # (relpath, cls, method) or None
        self.cross_class = cross_class
        self.in_init = in_init


def _class_facts(program) -> Dict[Tuple[str, str], _ClassFacts]:
    facts: Dict[Tuple[str, str], _ClassFacts] = {}
    for info in program.modules():
        for cls_name, cls in info.classes.items():
            f = _ClassFacts()
            f.bases = [callgraph.dotted_name(b) for b in cls.bases
                       if callgraph.dotted_name(b)]
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    f.methods[item.name] = item
            for node in callgraph.walk(cls):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call):
                    ctor = callgraph.last_attr(node.value.func)
                    for target in node.targets:
                        if isinstance(target, ast.Attribute) \
                                and isinstance(target.value, ast.Name) \
                                and target.value.id == "self":
                            if ctor in _LOCKY_CTORS:
                                f.lock_attrs.add(target.attr)
                            if ctor in _SYNC_CTORS:
                                f.sync_attrs.add(target.attr)
                elif isinstance(node, ast.Call) \
                        and callgraph.last_attr(node.func) == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target" \
                                and isinstance(kw.value, ast.Attribute) \
                                and isinstance(kw.value.value, ast.Name) \
                                and kw.value.value.id == "self":
                            f.entries.add(kw.value.attr)
            facts[(info.relpath, cls_name)] = f
    return facts


def _family(program, info, cls_name, facts, depth=3) \
        -> List[Tuple[str, str]]:
    """``[(relpath, class)]`` for a class and its resolvable bases, most
    derived first."""
    out, seen = [], set()

    def visit(inf, name, d):
        key = (inf.relpath, name)
        if key in seen or key not in facts or d < 0:
            return
        seen.add(key)
        out.append(key)
        for base in facts[key].bases:
            hit = program.resolve_class(inf, base)
            if hit is not None:
                visit(hit[0], hit[1].name, d - 1)

    visit(info, cls_name, depth)
    return out


def _is_locky(attr: str, recv_cls_key, facts) -> bool:
    if callgraph.name_tokens(attr) & _LOCK_TOKENS:
        return True
    f = facts.get(recv_cls_key) if recv_cls_key else None
    return f is not None and attr in f.lock_attrs


def _guard_items(items, recv_types, facts) -> Set[Tuple[str, str]]:
    """``(receiver name, lock attr)`` pairs a with-statement acquires."""
    out = set()
    for item in items:
        expr = item.context_expr
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            recv = expr.value.id
            if _is_locky(expr.attr, recv_types.get(recv), facts):
                out.add((recv, expr.attr))
    return out


def _walk_function(info, cls_name, cls_key, fn, program, facts, accesses,
                   helper_sites, scope_name):
    """One pass over a function/method: typed receivers, guard nesting,
    attribute accesses, intra-family self-call sites."""
    # Receiver typing: self, annotated params, ctor locals, and locals /
    # loop targets drawn from calls with class-valued return annotations.
    recv_types: Dict[str, Tuple[str, str]] = {}
    if cls_name is not None:
        recv_types["self"] = cls_key
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        if a.annotation is None or a.arg == "self":
            continue
        hit = _annotation_class(a.annotation)
        if hit and not hit[1]:
            r = program.resolve_class(info, hit[0])
            if r is not None:
                recv_types[a.arg] = (r[0].relpath, r[1].name)
    for name, (owner, c) in program.local_types(info, fn).items():
        recv_types.setdefault(name, (owner.relpath, c))

    def returns_class(call) -> Optional[Tuple[Tuple[str, str], bool]]:
        resolved = program.resolve_call(info, call, cls_name,
                                        program.local_types(info, fn))
        if resolved is None or getattr(resolved.fn, "returns", None) is None:
            return None
        hit = _annotation_class(resolved.fn.returns)
        if hit is None:
            return None
        r = program.resolve_class(resolved.info, hit[0])
        if r is None:
            return None
        return (r[0].relpath, r[1].name), hit[1]

    for stmt in fn.body:
        for node in callgraph.walk_executed(stmt):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                typed = returns_class(node.value)
                if typed and not typed[1]:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            recv_types.setdefault(t.id, typed[0])
            elif isinstance(node, ast.For) and isinstance(node.iter,
                                                          ast.Call) \
                    and isinstance(node.target, ast.Name):
                typed = returns_class(node.iter)
                if typed and typed[1]:
                    recv_types.setdefault(node.target.id, typed[0])

    in_init = cls_name is not None and fn.name == "__init__"
    method_key = (info.relpath, cls_name, fn.name) if cls_name else None
    module = info.module

    def visit(node, guards):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # deferred code: neither guarded by, nor walked under
        if isinstance(node, (ast.With, ast.AsyncWith)):
            added = _guard_items(node.items, recv_types, facts)
            for item in node.items:
                visit(item, guards)
            for body_stmt in node.body:
                visit(body_stmt, guards | added)
            return
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            recv = node.value.id
            recv_key = recv_types.get(recv)
            if recv_key is not None \
                    and not _is_locky(node.attr, recv_key, facts):
                f = facts.get(recv_key)
                if f is None or node.attr not in f.sync_attrs:
                    held = frozenset(g for r, g in guards if r == recv)
                    accesses.append(_Access(
                        node.attr, recv_key,
                        isinstance(node.ctx, (ast.Store, ast.Del)),
                        held, info.relpath, node.lineno, node.col_offset,
                        module.scope_at(node), method_key,
                        cross_class=(recv_key != cls_key
                                     or cls_name is None),
                        in_init=(in_init and recv == "self")))
        if isinstance(node, ast.Call) and cls_name is not None \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            held = frozenset(g for r, g in guards if r == "self")
            helper_sites.setdefault(
                (info.relpath, cls_name, node.func.attr), []).append(held)
        for child in callgraph.children(node):
            visit(child, guards)

    for stmt in fn.body:
        visit(stmt, frozenset())


@register_program("GL012", "guarded-field consistency (static race detector)")
def check_guarded_fields(program, ctx: Context) -> List[Finding]:
    """GL012 — attribute guarded in one method, bare in another.

    For each class, each instance attribute's guard is inferred from writes
    under ``with <receiver>._lock:`` blocks (single-guard agreement
    required). A bare read/write of the same attribute is a finding when the
    race is reachable: the bare site or the guarded writer runs on a spawned
    thread (``Thread(target=self.m)`` reachability over the class family's
    self-calls), or the access crosses a class boundary through a typed
    receiver (annotated params, constructor locals, class-valued return
    annotations). Locked helpers — methods only ever called under the guard
    — are credited with it; ``__init__`` writes and synchronization-object
    attributes are exempt. Suppress a deliberate lock-free read with
    ``# graftlint: disable=GL012(reason)`` on the access line — e.g. a
    monotonic flag read where one-round staleness is harmless.
    """
    facts = _class_facts(program)
    accesses: List[_Access] = []
    helper_sites: Dict[Tuple[str, str, str], List[frozenset]] = {}

    for info in program.modules():
        if not _checked_path(info.relpath):
            continue
        for name, fn in info.index.module_funcs.items():
            _walk_function(info, None, None, fn, program, facts, accesses,
                           helper_sites, name)
        for (cls_name, mname), fn in info.index.methods.items():
            _walk_function(info, cls_name, (info.relpath, cls_name), fn,
                           program, facts, accesses, helper_sites,
                           f"{cls_name}.{mname}")

    # Locked-helper credit: a method whose every intra-family call site
    # holds guard g is itself under g. Call sites recorded per defining
    # class; a subclass family's call into a base method (or vice versa)
    # credits the method wherever it is defined.
    family_of: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for info in program.modules():
        for cls_name in info.classes:
            key = (info.relpath, cls_name)
            family_of[key] = _family(program, info, cls_name, facts)

    def resolve_method(family, mname) -> Optional[Tuple[str, str, str]]:
        for rel, cname in family:
            if mname in facts[(rel, cname)].methods:
                return (rel, cname, mname)
        return None

    # A call site in a base class dispatches to subclass overrides at
    # runtime (`_BatcherBase.close` calling `self._inflight_locked()` runs
    # `Batcher._inflight_locked`) — credit the resolved method in every
    # class whose family contains the call site's class.
    descendants: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    for key, family in family_of.items():
        for fam_key in family:
            descendants.setdefault(fam_key, set()).add(key)

    helper_guards: Dict[Tuple[str, str, str], frozenset] = {}
    site_lists: Dict[Tuple[str, str, str], List[frozenset]] = {}
    for (rel, cname, mname), held_list in helper_sites.items():
        for dkey in descendants.get((rel, cname), {(rel, cname)}):
            target = resolve_method(family_of.get(dkey, []), mname)
            if target is not None:
                site_lists.setdefault(target, []).extend(held_list)
    for target, held_list in site_lists.items():
        common = frozenset.intersection(*held_list) if held_list \
            else frozenset()
        if common:
            helper_guards[target] = common

    # Thread-reachable methods: BFS from each family's Thread entries over
    # intra-family self-calls.
    caller_edges: Dict[Tuple[str, str, str], Set[str]] = {}
    for key, f in facts.items():
        rel, cname = key
        for mname, fn in f.methods.items():
            callees = set()
            for stmt in fn.body:
                for call in callgraph.calls_executed(stmt):
                    if isinstance(call.func, ast.Attribute) \
                            and isinstance(call.func.value, ast.Name) \
                            and call.func.value.id == "self":
                        callees.add(call.func.attr)
            caller_edges[(rel, cname, mname)] = callees

    threaded: Set[Tuple[str, str, str]] = set()
    for key, family in family_of.items():
        entries = set()
        for fam_key in family:
            entries |= facts[fam_key].entries
        if not entries:
            continue
        queue = [m for m in entries]
        seen_m: Set[str] = set()
        while queue:
            mname = queue.pop()
            if mname in seen_m:
                continue
            seen_m.add(mname)
            target = resolve_method(family, mname)
            if target is None:
                continue
            threaded.add(target)
            queue.extend(caller_edges.get(target, ()))

    # Group accesses by (class, attr); infer guards; emit findings.
    by_attr: Dict[Tuple[Tuple[str, str], str], List[_Access]] = {}
    for acc in accesses:
        if acc.in_init:
            continue
        eff = acc.guards
        if acc.method_key is not None and not acc.cross_class:
            eff = eff | helper_guards.get(acc.method_key, frozenset())
        acc.guards = eff
        by_attr.setdefault((acc.cls_key, acc.attr), []).append(acc)

    findings: List[Finding] = []
    for (cls_key, attr), accs in sorted(
            by_attr.items(), key=lambda kv: (kv[0][0][0], kv[0][0][1],
                                             kv[0][1])):
        if not _checked_path(cls_key[0]):
            continue
        guarded_writes = [a for a in accs if a.is_write and a.guards]
        if not guarded_writes:
            continue
        guards_used = set()
        for a in guarded_writes:
            guards_used |= a.guards
        lock_attrs = facts.get(cls_key, _ClassFacts()).lock_attrs
        preferred = guards_used & lock_attrs
        candidates = preferred or guards_used
        if len(candidates) != 1:
            continue  # ambiguous discipline: skip, don't guess
        guard = next(iter(candidates))
        if not all(guard in a.guards for a in guarded_writes):
            continue
        bare = [a for a in accs if guard not in a.guards]
        if not bare:
            continue

        def hot(a):
            return a.cross_class or (a.method_key in threaded)

        if not any(hot(a) for a in bare) \
                and not any(hot(a) for a in guarded_writes):
            continue
        bare.sort(key=lambda a: (a.relpath, a.line, a.col))
        first = bare[0]
        writer = guarded_writes[0]
        writer_where = writer.scope or writer.relpath
        kinds = ("written" if all(a.is_write for a in bare) else
                 "read" if not any(a.is_write for a in bare) else
                 "read/written")
        others = len(bare) - 1
        findings.append(Finding(
            "GL012", first.relpath, first.line, first.col,
            f"attribute `{cls_key[1]}.{attr}` is written under "
            f"`{guard}` (in {writer_where}) but {kinds} bare here"
            + (f" (+{others} more bare site{'s' if others > 1 else ''})"
               if others else "")
            + "; a thread holding the lock and this access race — take "
              f"`{guard}` here or suppress with the reason the lock-free "
              "access is safe",
            scope=first.scope))
    return findings
