"""Concurrency checks: GL001 lock-across-dispatch, GL002 lock order, GL005
unbounded blocking.

These descend from real bugs in the JAX package's history: concurrently
dispatched multi-device programs interleaved their collective rendezvous
(fixed by ``AsyncPSRunner._collective_lock``), and
``staleness.ParameterService`` documents a strict ``_write_mutex -> _lock``
order plus a "device execution never runs under the snapshot lock" rule. The
port keeps both disciplines; GL001's vocabulary is PyTorch's blocking device
work (host reads of device tensors, synchronizes, ``torch.distributed``
collectives and their work handles, CUDA-graph replays, the runner's
``run``/``run_many``) beside socket I/O and ``subprocess``.

GL001 and GL002 are WHOLE-PROGRAM checks: the lock-body reachability search
runs over :class:`~autodist_tpu_torch.analysis.program.ProgramIndex`, so a
``with lock:`` body that reaches ``runner.run`` or a socket send *through
another module* (the historical blind spot — resolution used to stop at
5 same-module hops) fails lint too.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (PACKAGE_PREFIX, Context, Finding,
                                              Module, register, register_program)

_LOCK_TOKENS = {"lock", "rlock", "mutex", "mtx", "cond", "condition",
                "sem", "semaphore"}
# The san_* names are testing/sanitizer.py's env-armed factories — disarmed
# they return the bare primitive, so a `self._lock = san_lock()` site is a
# lock definition exactly like `threading.Lock()` and must stay visible to
# _definite_locks (factory adoption must not blind GL001/GL002/GL012).
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
               "san_lock", "san_rlock", "san_condition"}
# Socket I/O, and PyTorch calls that wait for the card: a host read of a
# device tensor, a stream/event/device synchronize, a CUDA-graph replay.
_DISPATCH_ATTRS = {"sendall", "sendmsg", "sendto", "recv", "recv_into",
                   "recvfrom", "recvmsg", "connect", "accept",
                   "item", "tolist", "cpu", "numpy", "synchronize", "replay"}
_DISPATCH_METHODS = {"run", "run_many"}
# torch.distributed collectives: blocking by any receiver name...
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
                "all_to_all", "all_to_all_single", "batch_isend_irecv",
                "broadcast_object_list", "monitored_barrier"}
# ...and these only through the module (``dist.barrier()``), their bare
# names being too common to claim.
_DIST_ONLY = {"barrier", "broadcast", "reduce", "gather", "scatter", "send"}
_DIST_MODULES = ("dist", "torch.distributed")
# Asynchronous point-to-point and ``async_op=True`` collectives hand back a
# work handle whose ``.wait()`` blocks.
_ASYNC_P2P = {"isend", "irecv", "batch_isend_irecv"}
_WORK_TOKENS = {"work", "works", "handle", "handles", "req", "reqs",
                "request", "requests"}


def _definite_locks(tree: ast.Module) -> Set[str]:
    """Dotted targets assigned a ``threading.Lock()``-family constructor."""
    locks: Set[str] = set()
    for node in callgraph.walk(tree):
        if not isinstance(node, ast.Assign) \
                or not isinstance(node.value, ast.Call):
            continue
        ctor = callgraph.last_attr(node.value.func)
        if ctor not in _LOCK_CTORS:
            continue
        for target in node.targets:
            name = callgraph.dotted_name(target)
            if name:
                locks.add(name)
    return locks


def _lock_name(expr, definite: Set[str]) -> Optional[str]:
    """The lock's short name when ``expr`` looks like a lock, else None.
    Either the expression was assigned a threading constructor in this module,
    or its final identifier carries a lock-ish token (``_collective_lock``,
    ``_write_mutex``, ``_cond`` — token match, so "block" never trips)."""
    dotted = callgraph.dotted_name(expr)
    last = callgraph.last_attr(expr)
    if dotted is not None and dotted in definite:
        return last or dotted
    if callgraph.name_tokens(last) & _LOCK_TOKENS:
        return last
    return None


def _is_async_work(call: ast.Call) -> bool:
    if callgraph.last_attr(call.func) in _ASYNC_P2P:
        return True
    return any(k.arg == "async_op" and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


def _work_handles(tree: ast.Module) -> Set[str]:
    """Names bound to ``torch.distributed`` work handles: assigned from an
    ``isend``/``irecv``/``batch_isend_irecv`` or ``async_op=True`` call, or
    loop targets over one."""
    names: Set[str] = set()
    for node in callgraph.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _is_async_work(node.value):
            targets = node.targets
        elif isinstance(node, (ast.For, ast.comprehension)) \
                and isinstance(node.iter, ast.Call) \
                and _is_async_work(node.iter):
            targets = [node.target]
        else:
            continue
        for target in targets:
            name = callgraph.dotted_name(target)
            if name:
                names.add(name)
    return names


def _enclosing_class(module: Module, index: callgraph.ModuleIndex,
                     node) -> Optional[str]:
    """Class name owning ``node``'s enclosing method, for self-call resolution."""
    scope = module.scope_at(node)
    head = scope.split(".")[0] if scope else ""
    if any(cls == head for cls, _ in index.methods):
        return head
    return None


def _dispatch_predicate(handles_by_module: Dict[str, Set[str]]):
    """The GL001 blocking-call predicate, program-aware: work-handle name
    sets are per MODULE (the module whose code the search is currently in)."""

    def predicate(call: ast.Call, info) -> Optional[str]:
        dotted = callgraph.dotted_name(call.func)
        last = callgraph.last_attr(call.func)
        attr = isinstance(call.func, ast.Attribute)
        if attr and last in _DISPATCH_ATTRS:
            return dotted or last
        if attr and last in _DISPATCH_METHODS:
            return dotted or last
        if last in _COLLECTIVES:
            return dotted or last
        if attr and last in _DIST_ONLY and dotted is not None \
                and dotted.rsplit(".", 1)[0] in _DIST_MODULES:
            return dotted
        if dotted is not None and dotted.startswith("subprocess."):
            return dotted
        if attr and last == "wait" and not call.args and not call.keywords:
            recv = callgraph.dotted_name(call.func.value)
            handles = handles_by_module.get(info.relpath)
            if handles is None:
                handles = _work_handles(info.module.tree)
                handles_by_module[info.relpath] = handles
            if recv in handles or callgraph.name_tokens(
                    callgraph.last_attr(call.func.value)) & _WORK_TOKENS:
                return f"{dotted or 'wait'} (work handle)"
        return None

    return predicate


def _scope_function(module: Module, node):
    """The enclosing FunctionDef of ``node`` (for local-type inference), or
    None at module level."""
    return callgraph.innermost_function(module.tree, node)


@register_program("GL001", "lock held across device dispatch / blocking I/O")
def check_lock_across_dispatch(program, ctx: Context) -> List[Finding]:
    """GL001 — lock-held-across-dispatch (interprocedural).

    Flags a ``with <lock>:`` body that reaches a blocking operation — a
    host read of a device tensor (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``), a ``.synchronize()`` (``torch.cuda``, an ``Event``, a
    ``Stream``), a ``torch.distributed`` collective or a work handle's
    ``.wait()``, a ``CUDAGraph.replay()``, ``runner.run``/``run_many``,
    ``subprocess``, or socket send/recv — directly or through helper calls,
    ACROSS MODULE BOUNDARIES: resolution runs over the
    whole-program call graph (imports, ``module.f()`` chains, methods of
    locally-constructed instances; bounded at
    :data:`~autodist_tpu_torch.analysis.program.MAX_DEPTH` hops). Holding a lock
    across multi-device execution can wedge the collective rendezvous —
    the deadlock that once hung the JAX package's whole suite — and holding a hot-path snapshot lock across device execution
    stalls every reader for a whole program (the
    ``staleness.ParameterService`` rule: the apply's device execution runs
    under the writer mutex only, never the snapshot Condition). The old
    same-module 5-hop limit was the documented blind spot this closes: a
    critical section that reached a socket send through an imported helper
    passed lint until now.

    Locks that exist precisely to serialize execution (e.g.
    ``AsyncPSRunner._collective_lock``) are legitimate; annotate those sites
    with ``# graftlint: disable=GL001(reason)`` so the intent is explicit and
    reviewed, instead of implicit and forgettable.
    """
    findings: List[Finding] = []
    handles_by_module: Dict[str, Set[str]] = {}
    predicate = _dispatch_predicate(handles_by_module)
    for info in program.modules():
        module = info.module
        definite = _definite_locks(module.tree)
        for node in callgraph.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                lock = _lock_name(item.context_expr, definite)
                if lock is None:
                    continue
                cls = _enclosing_class(module, info.index, node)
                hit = program.find_reaching_call(
                    info, list(node.body), cls,
                    _scope_function(module, node), predicate)
                if hit is None:
                    continue
                _, label, path = hit
                via = " via " + " -> ".join(path[:-1]) if len(path) > 1 else ""
                findings.append(Finding(
                    "GL001", module.relpath, node.lineno, node.col_offset,
                    f"lock `{lock}` is held across blocking call "
                    f"`{label}`{via}; dispatching device programs or socket "
                    f"I/O inside a critical section risks deadlocking the "
                    f"collective rendezvous and stalls every other "
                    f"thread on the lock",
                    scope=module.scope_at(node)))
                break  # one finding per with-statement is enough signal
    return findings


def _lock_identity(program, info, expr_or_name, definite: Set[str]):
    """The IDENTITY of a lock — ``(defining module relpath, name)`` — when
    statically knowable, else None. A bare name is only comparable across
    modules through its definition site: `_lock` in two unrelated modules
    is two locks; `a_lock` imported by both from the same module is one."""
    if isinstance(expr_or_name, str):
        name = expr_or_name
        sym = info.import_sym.get(name)
        if sym is not None:
            target = program.by_dotted.get(sym[0])
            return ((target.relpath if target is not None else sym[0]),
                    sym[1])
        if name in definite:
            return (info.relpath, name)
        return None
    if isinstance(expr_or_name, ast.Name):
        return _lock_identity(program, info, expr_or_name.id, definite)
    dotted = callgraph.dotted_name(expr_or_name)
    if dotted is not None and dotted in definite:
        return (info.relpath, dotted)
    return None


def _nested_lock_edges(program, info, definite: Set[str],
                       definite_by_module: Dict[str, Set[str]]):
    """(outer, inner, node, report_module) lock-acquisition edges: direct
    ``with`` nesting plus one level of call resolution — now PROGRAM-wide,
    so ``with a_lock: other_module.helper()`` sees the ``with b_lock:``
    inside the helper. The finding stays anchored in the module holding the
    outer lock (where the fix belongs); the inner module's definite-lock
    and declared-order facts still apply."""
    module = info.module
    edges = []
    for node in callgraph.walk(module.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        outers = [(
            _lock_name(i.context_expr, definite),
            _lock_identity(program, info, i.context_expr, definite))
            for i in node.items]
        outers = [(o, oid) for o, oid in outers if o]
        if not outers:
            continue
        cls = _enclosing_class(module, info.index, node)
        scope_fn = _scope_function(module, node)
        local_types = program.local_types(info, scope_fn) \
            if scope_fn is not None else {}
        # walk_executed: a `with B:` inside a def merely DEFINED under A is
        # deferred code — not an A->B acquisition.
        inner_withs = [(sub, info) for body in node.body
                       for sub in callgraph.walk_executed(body)
                       if isinstance(sub, (ast.With, ast.AsyncWith))]
        for call in (c for body in node.body
                     for c in callgraph.calls_executed(body)):
            resolved = program.resolve_call(info, call, cls, local_types)
            if resolved is not None:
                inner_withs.extend(
                    (sub, resolved.info) for stmt in resolved.fn.body
                    for sub in callgraph.walk_executed(stmt)
                    if isinstance(sub, (ast.With, ast.AsyncWith)))
        for sub, sub_info in inner_withs:
            if sub_info is info:
                sub_definite = definite
            else:
                sub_definite = definite_by_module.get(sub_info.relpath)
                if sub_definite is None:
                    sub_definite = _definite_locks(sub_info.module.tree)
                    definite_by_module[sub_info.relpath] = sub_definite
            for item in sub.items:
                inner = _lock_name(item.context_expr, sub_definite)
                if inner is None:
                    continue
                if sub_info is not info and not (
                        isinstance(item.context_expr, ast.Name)
                        and item.context_expr.id in sub_definite):
                    # A foreign CLASS's instance-internal leaf lock
                    # (metrics' per-instrument `self._lock`, the queue's
                    # `self._cond`) is that module's encapsulated
                    # discipline — its own intra-module pass orders it.
                    # Cross-module edges track the callee's MODULE-GLOBAL
                    # locks, where an inversion is two subsystems racing.
                    continue
                inner_id = _lock_identity(program, sub_info,
                                          item.context_expr, sub_definite)
                anchor = sub if sub_info is info else node
                for outer, outer_id in outers:
                    if outer != inner:
                        edges.append((outer, inner, anchor, sub_info,
                                      outer_id, inner_id))
    return edges


@register_program("GL002", "lock-order inversion / undeclared nesting")
def check_lock_order(program, ctx: Context) -> List[Finding]:
    """GL002 — lock-order inversion (interprocedural).

    Derives the acquisition order of named locks (direct ``with`` nesting
    plus one level of call resolution, including calls INTO OTHER MODULES
    via the program call graph) and flags (a) any pair acquired in both
    orders anywhere in the module — a classic ABBA deadlock — and (b) any
    nested acquisition not covered by a declared order directive. Declare
    the intended order once, next to the lock definitions:

        # graftlint: lock-order=_write_mutex->_lock

    A cross-module edge honors the declaration in EITHER module involved
    (the lock's home module is where its discipline is documented). The
    directive is the machine-readable version of the prose rule
    ``staleness.ParameterService`` always had ("Order: _write_mutex ->
    _lock, never the reverse"); with it declared, a future path acquiring
    ``_lock`` then ``_write_mutex`` fails lint instead of deadlocking a
    production chief under load.
    """
    findings: List[Finding] = []
    definite_by_module: Dict[str, Set[str]] = {
        info.relpath: _definite_locks(info.module.tree)
        for info in program.modules()}
    # Cross-module comparisons run on lock IDENTITY ((defining module,
    # name) — resolved through imports), never on bare names: `_lock` in
    # two unrelated modules is two locks, while `a_lock` two modules both
    # import from a shared module is one. Two modules declaring (a, b) and
    # (b, a) over the SAME identity pair — or acquiring one in opposite
    # orders through each other's helpers — are two subsystems one
    # scheduler decision away from deadlock. Same-module edges keep
    # module-local name matching as before.
    decls = []   # (relpath, a, b, id(a), id(b))
    for info in program.modules():
        definite = definite_by_module[info.relpath]
        for a, b in sorted(set(info.module.lock_orders)):
            decls.append((info.relpath, a, b,
                          _lock_identity(program, info, a, definite),
                          _lock_identity(program, info, b, definite)))
    for rel, a, b, ida, idb in decls:
        if ida is None or idb is None:
            continue
        for rel2, a2, b2, ida2, idb2 in decls:
            if rel2 > rel and (ida2, idb2) == (idb, ida):
                findings.append(Finding(
                    "GL002", rel2, 1, 0,
                    f"declares lock-order `{a2}` -> `{b2}`, contradicting "
                    f"{rel}'s declared `{a}` -> `{b}` over the same locks; "
                    f"the two modules promise opposite acquisition orders "
                    f"— one of the declarations (and its paths) must flip"))
    cross_seen: Dict[Tuple[Tuple[str, str], Tuple[str, str]], str] = {}
    for info in program.modules():
        module = info.module
        definite = definite_by_module[info.relpath]
        declared = set(module.lock_orders)
        seen: Dict[Tuple[str, str], ast.AST] = {}
        reported: Set[Tuple[str, str, str]] = set()

        for outer, inner, node, sub_info, outer_id, inner_id \
                in _nested_lock_edges(program, info, definite,
                                      definite_by_module):
            scope = module.scope_at(node)
            if (outer, inner, scope) in reported:
                continue
            reported.add((outer, inner, scope))
            cross = sub_info is not info
            edge_declared = declared if not cross \
                else declared | set(sub_info.module.lock_orders)
            if outer_id is not None and inner_id is not None:
                # Program-wide ABBA runs on every identity-resolved edge
                # (direct nestings of shared imported locks included, not
                # just call-resolved ones), and is NOT exempted by a
                # module's own-direction declaration: declaring your order
                # does not make the other module's opposite acquisition
                # safe — the conflict is the deadlock. Same-module
                # inversions stay with the name-based per-module pass.
                other = cross_seen.get((inner_id, outer_id))
                if other is not None and other != module.relpath:
                    findings.append(Finding(
                        "GL002", module.relpath, node.lineno,
                        node.col_offset,
                        f"acquires `{inner}` while holding `{outer}`, but "
                        f"{other} takes the same locks in the opposite "
                        f"order — a program-wide ABBA deadlock across "
                        f"modules",
                        scope=scope))
                cross_seen.setdefault((outer_id, inner_id), module.relpath)
            if (inner, outer) in seen or (inner, outer) in edge_declared:
                findings.append(Finding(
                    "GL002", module.relpath, node.lineno, node.col_offset,
                    f"acquires `{inner}` while holding `{outer}`, "
                    f"conflicting with the established order `{inner}` -> "
                    f"`{outer}`; two threads taking these locks in opposite "
                    f"orders deadlock each other",
                    scope=scope))
            elif (outer, inner) not in edge_declared:
                findings.append(Finding(
                    "GL002", module.relpath, node.lineno, node.col_offset,
                    f"nested lock acquisition `{outer}` -> `{inner}` has no "
                    f"declared order; add `# graftlint: "
                    f"lock-order={outer}->{inner}` at module level so future "
                    f"paths cannot silently invert it",
                    scope=scope))
            seen.setdefault((outer, inner), node)
    return findings


def static_lock_edges(program) -> Dict[Tuple[Tuple[str, str],
                                             Tuple[str, str]],
                                       Tuple[str, int]]:
    """Every identity-resolved static lock-order edge, for ``--crosscheck``:
    ``{((outer relpath, outer name), (inner relpath, inner name)):
    (reporting module, line)}``. Same harvest GL002 runs on, restricted to
    edges whose both endpoints resolve to a definition site — the only ones
    a runtime observation can be matched against."""
    definite_by_module = {info.relpath: _definite_locks(info.module.tree)
                          for info in program.modules()}
    edges: Dict[Tuple[Tuple[str, str], Tuple[str, str]],
                Tuple[str, int]] = {}
    for info in program.modules():
        definite = definite_by_module[info.relpath]
        for (_outer, _inner, node, _sub, outer_id, inner_id) \
                in _nested_lock_edges(program, info, definite,
                                      definite_by_module):
            if outer_id is None or inner_id is None:
                continue
            edges.setdefault((outer_id, inner_id),
                             (info.relpath, node.lineno))
    return edges


def _fmt_site(key) -> str:
    path, name, cls = key
    return f"{path}:{name}" + (f" ({cls})" if cls else "")


def crosscheck(program, observed: List[dict]) \
        -> Tuple[List[Finding], List[dict]]:
    """Merge sanitizer-observed lock-order edges into GL002's static graph.

    ``observed`` is the parsed edge records from
    ``.graftlint_cache/observed_locks.jsonl`` (``testing/sanitizer.py``
    export): ``{"outer": {"path", "name", "cls"}, "inner": {...},
    "count": n}``. Site keys align with GL002's lock identities by
    construction — the sanitizer keys a lock by its creation site's
    ``(repo-relative path, assignment lhs)``, the same ``(relpath,
    "self._lock")`` pair ``_lock_identity`` resolves.

    Returns ``(findings, unexercised)``:

    - a cycle in the MERGED observed digraph is a finding — each in-process
      run aborts on its own cycles, so one surviving the merge is
      dynamic-only evidence spanning runs/processes that no single
      execution (and no static identity edge) could show;
    - an observed edge whose reverse direction exists as a static identity
      edge is a finding — the runtime took the locks in the opposite order
      the code's static nesting establishes (ABBA with one half dynamic);
    - a static identity edge never observed is returned in ``unexercised``
      (informational): the lock model has coverage the test run didn't
      earn, the same way an untested branch reads.
    """
    static = static_lock_edges(program)
    static_pairs = {((o[0], o[1]), (i[0], i[1])): loc
                    for (o, i), loc in static.items()}

    def nkey(d: dict):
        return (d.get("path", "?"), d.get("name", "?"), d.get("cls"))

    adj: Dict[tuple, Set[tuple]] = {}
    obs_edges: Set[Tuple[tuple, tuple]] = set()
    for rec in observed:
        o, i = nkey(rec["outer"]), nkey(rec["inner"])
        adj.setdefault(o, set()).add(i)
        obs_edges.add((o, i))

    findings: List[Finding] = []

    # (a) cycles in the merged observed digraph.
    color: Dict[tuple, int] = {}
    stack: List[tuple] = []
    seen_cycles: Set[frozenset] = set()

    def dfs(u):
        color[u] = 1
        stack.append(u)
        for v in sorted(adj.get(u, ()), key=str):
            c = color.get(v, 0)
            if c == 0:
                dfs(v)
            elif c == 1:
                cyc = stack[stack.index(v):] + [v]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    findings.append(Finding(
                        "GL002", cyc[0][0], 1, 0,
                        "crosscheck: observed lock-order cycle "
                        + " -> ".join(_fmt_site(n) for n in cyc)
                        + " in the merged runtime edges; no single "
                        "acquisition order exists — a dynamic-only "
                        "deadlock the static graph cannot see",
                        scope=None))
        stack.pop()
        color[u] = 2

    for u in sorted(adj, key=str):
        if color.get(u, 0) == 0:
            dfs(u)

    # (b) observed edges contradicting a static identity edge.
    for o, i in sorted(obs_edges, key=str):
        loc = static_pairs.get(((i[0], i[1]), (o[0], o[1])))
        if loc is not None:
            rel, line = loc
            findings.append(Finding(
                "GL002", rel, line, 0,
                f"crosscheck: runtime acquired {_fmt_site(i)} while "
                f"holding {_fmt_site(o)}, the opposite of the static "
                f"nesting established here — an ABBA deadlock with one "
                f"half only reachable dynamically",
                scope=None))

    # (c) static identity edges the run never exercised.
    observed_pairs = {((o[0], o[1]), (i[0], i[1])) for o, i in obs_edges}
    unexercised = [
        {"outer": {"path": okey[0], "name": okey[1]},
         "inner": {"path": ikey[0], "name": ikey[1]},
         "path": rel, "line": line}
        for (okey, ikey), (rel, line) in sorted(static.items())
        if (okey, ikey) not in observed_pairs]
    return findings, unexercised


@register("GL005", "unbounded blocking wait in runtime code")
def check_unbounded_wait(module: Module, ctx: Context) -> List[Finding]:
    """GL005 — blocking call without a timeout path.

    In ``autodist_tpu_torch/`` runtime code (handlers the PS transport runs per
    connection, gate waits, prefetch joins), flags ``Condition.wait`` /
    ``wait_for`` / ``Event.wait`` calls with no timeout argument (or a
    literal ``None``): a dead peer or wedged producer then parks the thread
    forever with no diagnosable failure. The PS server bounds the
    wait-indefinitely gate default for the same reason
    (``ps_transport._dispatch``: client-requested finite timeouts are
    honored exactly; ``None`` gets a 24h ceiling so a vanished peer cannot
    park handler threads forever). Tests and tools are exempt (a test
    hanging is loud; a server thread leaking is silent).
    """
    if module.tree is None or not module.relpath.startswith(PACKAGE_PREFIX):
        return []
    findings: List[Finding] = []
    for call in callgraph.calls_under(module.tree):
        last = callgraph.last_attr(call.func)
        if last not in ("wait", "wait_for"):
            continue
        if last == "wait":
            receiver = call.func.value if isinstance(call.func, ast.Attribute) \
                else None
            tokens = callgraph.name_tokens(callgraph.last_attr(receiver))
            if not tokens & (_LOCK_TOKENS | {"event", "ev", "done", "ready"}):
                continue  # p.wait() on a process etc. — not a lock primitive
            has_timeout = bool(call.args) or any(
                k.arg == "timeout" for k in call.keywords)
            timeout_arg = call.args[0] if call.args else next(
                (k.value for k in call.keywords if k.arg == "timeout"), None)
        else:
            has_timeout = len(call.args) >= 2 or any(
                k.arg == "timeout" for k in call.keywords)
            timeout_arg = call.args[1] if len(call.args) >= 2 else next(
                (k.value for k in call.keywords if k.arg == "timeout"), None)
        if has_timeout and not (isinstance(timeout_arg, ast.Constant)
                                and timeout_arg.value is None):
            continue
        dotted = callgraph.dotted_name(call.func) or last
        findings.append(Finding(
            "GL005", module.relpath, call.lineno, call.col_offset,
            f"unbounded `{dotted}` — no timeout, so a dead peer or wedged "
            f"producer parks this thread forever; pass a timeout and handle "
            f"expiry (see StalenessController.start_step)",
            scope=module.scope_at(call)))
    return findings
