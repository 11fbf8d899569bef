"""GL011 — wire-retry idempotency: the opcode/retry contract, whole-program.

The JAX package's history: the wire retry replayed ``register(None)`` after a
transport reset — each replay ALLOCATED a fresh worker slot, leaving a
phantom live registration pinning ``min(steps)`` forever. The fix carved it
out of the retry policy (``ps_transport._retry_safe``), and the policy's
ground truth is a reified table: :data:`ps_transport.IDEMPOTENT_OPS`. But a
table nothing checks rots like any convention — this check joins it to
GL006's dispatch-arm tables, ACROSS modules:

- **every ``IDEMPOTENT_OPS`` member must have a ``_dispatch`` arm**
  somewhere in the program. A typo'd member (``"regster"``) silently
  changes retry policy for the real opcode — the request surfaces its
  first transient failure instead of retrying — and a stale member is dead
  vocabulary masquerading as a contract.
- **every opcode literal flowing into ``call_raw`` directly**
  (``client.call_raw(("op", ...), counters)`` — the overlapped/background
  exchange shape, in ANY module, found via cross-module receiver typing)
  **must be in ``IDEMPOTENT_OPS``**: ``call_raw``'s transparent
  reconnect-and-retry consults the table, so an unclassified op on that
  path gets NO retry and its mid-exchange failure poisons an overlapped
  socket with no protocol recovery — and classifying it carelessly is the
  ``register(None)`` replay. Either the op is replay-safe (add it to the
  table, with the carve-outs ``_retry_safe`` documents) or it belongs on
  ``call()``'s surface-the-error path.
- **every ``.call("op")`` on a transport client resolved across modules**
  (``adtop``'s ``_PSClient(address).call("status")``) must have a
  ``_dispatch`` arm somewhere in the program — the cross-module lift of
  GL006, which only pairs sends with arms inside one module.

The check activates only when the program defines an ``IDEMPOTENT_OPS``
set; fixture trees without the contract are out of scope.
"""

import ast
from typing import List, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import Context, Finding, register_program
from autodist_tpu_torch.analysis.checks.wire_protocol import _str_compares


def _idempotent_ops(program) -> List[Tuple[object, ast.Assign, Set[str]]]:
    """(module info, assignment node, member set) for every
    ``IDEMPOTENT_OPS = frozenset({...})`` / set / tuple literal — in
    NON-TEST modules (a test fake's table must not define the contract,
    the GL009 symmetry rule)."""
    out = []
    for info in program.modules():
        if info.relpath.startswith("tests/"):
            continue
        for node in info.module.tree.body:
            if not isinstance(node, ast.Assign) or not any(
                    isinstance(t, ast.Name) and t.id == "IDEMPOTENT_OPS"
                    for t in node.targets):
                continue
            value = node.value
            if isinstance(value, ast.Call) \
                    and callgraph.last_attr(value.func) in ("frozenset",
                                                            "set") \
                    and value.args:
                value = value.args[0]
            elts = getattr(value, "elts", None)
            if elts is None and isinstance(value, ast.Set):
                elts = value.elts
            if elts is None:
                continue
            members = {e.value for e in elts
                       if isinstance(e, ast.Constant)
                       and isinstance(e.value, str)}
            out.append((info, node, members))
    return out


def _program_dispatch_arms(program) -> Set[str]:
    """Union of every ``_dispatch`` arm table in NON-TEST modules
    (module-level functions and methods — GL006's per-module tables,
    joined). A test fake server's arms must not mask a missing production
    arm, exactly as a test-booked metric must not mask a dead selector."""
    arms: Set[str] = set()
    for info in program.modules():
        if info.relpath.startswith("tests/"):
            continue
        fns = []
        if "_dispatch" in info.index.module_funcs:
            fns.append(info.index.module_funcs["_dispatch"])
        fns.extend(fn for (cls, name), fn in info.index.methods.items()
                   if name == "_dispatch")
        for fn in fns:
            arms |= _str_compares(fn, "op")
    return arms


def _transport_client_classes(program) -> Set[Tuple[str, str]]:
    """(relpath, class name) of classes defining BOTH ``call_raw`` and
    ``call`` — the raw-exchange + checked-reply pairing that identifies a
    transport client (a class that merely happens to name some method
    ``call_raw`` is not one)."""
    out: Set[Tuple[str, str]] = set()
    for info in program.modules():
        have_raw = {cls for (cls, name) in info.index.methods
                    if name == "call_raw"}
        have_call = {cls for (cls, name) in info.index.methods
                     if name == "call"}
        for cls in have_raw & have_call:
            out.add((info.relpath, cls))
    return out


def _receiver_is_transport_client(program, info, call: ast.Call,
                                  clients: Set[Tuple[str, str]],
                                  scope_fn, current_class) -> bool:
    """Does this ``.call``/``.call_raw`` receiver statically resolve to a
    class that defines ``call_raw``? Resolution covers locally-constructed
    instances, ``self._client``-style attributes, ``self`` inside such a
    class, and ANNOTATED parameters (``client: _PSClient`` — the overlapped
    prefetch helper's shape)."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    if isinstance(recv, ast.Name):
        if recv.id == "self" and current_class \
                and (info.relpath, current_class) in clients:
            return True
        local = program.local_types(info, scope_fn) \
            if scope_fn is not None else {}
        typed = local.get(recv.id)
        if typed is not None:
            return (typed[0].relpath, typed[1]) in clients
        if scope_fn is not None:
            args = scope_fn.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.arg == recv.id and a.annotation is not None:
                    dotted = callgraph.dotted_name(a.annotation)
                    hit = program.resolve_class(info, dotted) \
                        if dotted else None
                    return hit is not None \
                        and (hit[0].relpath, hit[1].name) in clients
        return False
    if isinstance(recv, ast.Attribute) \
            and isinstance(recv.value, ast.Name) \
            and recv.value.id == "self" and current_class:
        typed = program.attr_types(info, current_class).get(recv.attr)
        return typed is not None \
            and (typed[0].relpath, typed[1]) in clients
    return False


def _enclosing_fn_and_class(module, index, node):
    """(innermost enclosing def, owning class name) for a call node."""
    best = callgraph.innermost_function(module.tree, node)
    cls = None
    if best is not None:
        scope = module.scope_at(node)
        head = scope.split(".")[0] if scope else ""
        if any(c == head for c, _ in index.methods):
            cls = head
    return best, cls


@register_program("GL011", "wire opcode outside the idempotency contract "
                           "or retry table without a dispatch arm",
                  full_program=True)
def check_wire_idempotency(program, ctx: Context) -> List[Finding]:
    """GL011 — wire-retry idempotency (see the module docstring).

    The contract under test is ``ps_transport``'s: ``IDEMPOTENT_OPS`` is
    the retry policy's ground truth (the ``register(None)`` replay is
    the incident class), ``_dispatch`` arm tables are the vocabulary
    (GL006), and ``call_raw`` is the raw-exchange surface background paths
    use. All three are joined program-wide, so an op sent from ``tools/``
    against an arm defined in ``parallel/`` — or a raw exchange added two
    modules away from the table — is checked the same as a same-module one.
    """
    findings: List[Finding] = []
    tables = _idempotent_ops(program)
    if not tables:
        return []
    all_ops: Set[str] = set()
    for _, _, members in tables:
        all_ops |= members
    arms = _program_dispatch_arms(program)
    clients = _transport_client_classes(program)

    # -- table members need arms somewhere ----------------------------------
    if arms:
        for info, node, members in tables:
            for op in sorted(members - arms):
                findings.append(Finding(
                    "GL011", info.relpath, node.lineno, node.col_offset,
                    f"IDEMPOTENT_OPS member {op!r} has no `_dispatch` arm "
                    f"anywhere in the program; a typo'd or stale entry "
                    f"silently changes the retry policy for the real "
                    f"opcode",
                    scope=info.module.scope_at(node)))

    # -- raw-exchange ops must be classified; client sends need arms --------
    for info in program.modules():
        module = info.module
        if module.relpath.startswith("tests/"):
            continue   # tests deliberately send bogus ops at error paths
        for call in callgraph.calls_under(module.tree):
            last = callgraph.last_attr(call.func)
            if last == "call_raw" and isinstance(call.func, ast.Attribute) \
                    and call.args and isinstance(call.args[0], ast.Tuple) \
                    and call.args[0].elts \
                    and isinstance(call.args[0].elts[0], ast.Constant) \
                    and isinstance(call.args[0].elts[0].value, str):
                op = call.args[0].elts[0].value
                scope_fn, cls = _enclosing_fn_and_class(module, info.index,
                                                        call)
                if not _receiver_is_transport_client(
                        program, info, call, clients, scope_fn, cls):
                    continue   # some unrelated class's call_raw method
                if op not in all_ops:
                    findings.append(Finding(
                        "GL011", module.relpath, call.lineno,
                        call.col_offset,
                        f"opcode {op!r} flows into the raw retry path "
                        f"(`call_raw`) but is not in IDEMPOTENT_OPS; an "
                        f"unclassified op gets no reconnect-retry and its "
                        f"mid-exchange failure poisons the overlapped "
                        f"socket — classify it (only if a replay is safe: "
                        f"the register(None) lesson) or route it through "
                        f"`call()`",
                        scope=module.scope_at(call)))
                continue
            if last != "call" or not isinstance(call.func, ast.Attribute) \
                    or not call.args \
                    or not isinstance(call.args[0], ast.Constant) \
                    or not isinstance(call.args[0].value, str):
                continue
            op = call.args[0].value
            if op in arms or not arms:
                continue
            scope_fn, cls = _enclosing_fn_and_class(module, info.index, call)
            if not _receiver_is_transport_client(program, info, call,
                                                 clients, scope_fn, cls):
                continue
            findings.append(Finding(
                "GL011", module.relpath, call.lineno, call.col_offset,
                f"opcode {op!r} is sent on a transport client but no "
                f"`_dispatch` in the whole program has an arm for it; "
                f"every request would error as unknown-op (GL006, lifted "
                f"across modules)",
                scope=module.scope_at(call)))
    return findings
