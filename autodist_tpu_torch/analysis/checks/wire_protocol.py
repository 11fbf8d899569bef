"""GL006 — wire-protocol exhaustiveness and frame-version ordering.

A byte-level mismatch between wire endpoints costs a whole run: an opcode the
client sends but the server never dispatches turns into a per-step (or
per-request) "unknown op" error loop; a codec tag with an encode arm but no
decode arm is a guaranteed ``WireError`` at the first message carrying it;
and parsing a payload length before validating the frame-version byte
misreads an incompatible future framing as an absurd length (exactly what
the framing redesign guarded against).

Two transports speak this wire today — the PS training plane
(``parallel/ps_transport.py``) and the serving plane
(``serving/transport.py``) — and the check is deliberately SHAPE-based, not
path-based: any module pairing ``.call("op", ...)`` client sends with a
``_dispatch`` arm table gets the same exhaustiveness guarantee, so the next
transport is covered the day it is written. A module may host several server
classes (each with its own ``_dispatch``); an op is satisfied when ANY of
them handles it.
"""

import ast
from typing import List, Optional, Set, Tuple

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import Context, Finding, Module, register


def _str_compares(fn, var: str) -> Set[str]:
    """String constants ``var`` is compared against (==, or ``in (tuple)``)."""
    out: Set[str] = set()
    for node in callgraph.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        if not (isinstance(node.left, ast.Name) and node.left.id == var):
            continue
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq) and isinstance(comp, ast.Constant) \
                    and isinstance(comp.value, str):
                out.add(comp.value)
            elif isinstance(op, ast.In) \
                    and isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                out.update(e.value for e in comp.elts
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str))
    return out


def _sent_ops(tree: ast.Module) -> List[Tuple[str, ast.Call]]:
    """(op, call) pairs for client sends: ``.call("op", ...)`` and
    ``.call_raw(("op", ...), ...)``."""
    out: List[Tuple[str, ast.Call]] = []
    for node in callgraph.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        last = callgraph.last_attr(node.func)
        if last == "call" and isinstance(node.func, ast.Attribute) \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.append((node.args[0].value, node))
        elif last == "call_raw" and node.args \
                and isinstance(node.args[0], ast.Tuple) \
                and node.args[0].elts \
                and isinstance(node.args[0].elts[0], ast.Constant) \
                and isinstance(node.args[0].elts[0].value, str):
            out.append((node.args[0].elts[0].value, node))
    return out


def _bytes_tags_appended(fn) -> Set[bytes]:
    """Single-byte bytes constants appended ``out += b"X"`` in the encoder."""
    out: Set[bytes] = set()
    for node in callgraph.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, bytes) \
                and len(node.value.value) == 1:
            out.add(node.value.value)
    return out


def _with_helpers(index: callgraph.ModuleIndex, fn) -> List[ast.AST]:
    """``fn`` plus every module-level function it reaches by bare-name
    calls, transitively: a codec that writes a tag from a helper
    (``_enc_tensor`` writing ``b"a"`` for ``_enc``) still encodes it."""
    out, seen, stack = [], set(), [fn]
    while stack:
        f = stack.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        out.append(f)
        for call in callgraph.calls_under(f):
            if isinstance(call.func, ast.Name):
                callee = index.module_funcs.get(call.func.id)
                if callee is not None:
                    stack.append(callee)
    return out


def _bytes_tags_compared(fn, var: str) -> Set[bytes]:
    out: Set[bytes] = set()
    for node in callgraph.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        if not (isinstance(node.left, ast.Name) and node.left.id == var):
            continue
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq) and isinstance(comp, ast.Constant) \
                    and isinstance(comp.value, bytes) \
                    and len(comp.value) == 1:
                out.add(comp.value)
    return out


@register("GL006", "wire opcode/tag without a matching peer arm; "
                   "frame version unchecked")
def check_wire_protocol(module: Module, ctx: Context) -> List[Finding]:
    """GL006 — wire-opcode exhaustiveness.

    Three structural invariants of the zero-copy wire (``parallel/wire.py``,
    spoken by ``parallel/ps_transport.py`` AND the serving transport
    ``serving/transport.py``), checked wherever the same shapes appear:

    - Every opcode a client sends (``.call("op", ...)`` /
      ``.call_raw(("op", ...))``) must have a dispatch arm (``op == "..."``)
      in one of the module's ``_dispatch`` functions (module-level or
      method; arms union across server classes). A missing arm is a
      per-step error loop in training and a 100%-error-rate op in serving —
      e.g. adding a ``read_min`` client without the server arm would break
      every overlapped worker against the new chief, and a serving client
      op without an ``InferenceServer._dispatch`` arm rejects every request
      carrying it.
    - In a codec module (functions named ``_enc``/``_dec``): every one-byte
      tag the encoder emits (``out += b"X"``, in ``_enc`` or a module
      function it calls, such as the port's ``_enc_tensor``) must have a
      decode arm (``tag == b"X"``) and vice versa — an asymmetric tag is a guaranteed
      WireError on the first message that carries it.
    - In a module defining ``_FRAME_VERSION``: any function unpacking the
      frame header struct (a name containing ``HDR``) must reference
      ``_FRAME_VERSION`` — i.e. version validation and length parsing stay
      in one place (``_frame_len``), so an incompatible future framing is
      rejected instead of misparsed as a length.
    """
    if module.tree is None:
        return []
    findings: List[Finding] = []
    index = callgraph.ModuleIndex(module.tree)

    # -- opcode exhaustiveness (gated on a _dispatch function existing) -----
    # Union the arms of EVERY _dispatch in the module (module-level function
    # plus any number of methods): the serving transport hosts its dispatcher
    # as a server-class method, and a module with several server classes
    # must not check one client's ops against another class's arm table.
    dispatchers = []
    if "_dispatch" in index.module_funcs:
        dispatchers.append(index.module_funcs["_dispatch"])
    dispatchers.extend(fn for (cls, name), fn in index.methods.items()
                       if name == "_dispatch")
    handled: Set[str] = set()
    for dispatch in dispatchers:
        handled |= _str_compares(dispatch, "op")
    if handled:
        for op, call in _sent_ops(module.tree):
            if op not in handled:
                findings.append(Finding(
                    "GL006", module.relpath, call.lineno, call.col_offset,
                    f"opcode {op!r} is sent but `_dispatch` has no arm "
                    f"for it; every request would error as unknown-op",
                    scope=module.scope_at(call)))

    # -- codec tag symmetry (gated on _enc/_dec both existing) --------------
    enc = index.module_funcs.get("_enc")
    dec = index.module_funcs.get("_dec")
    if enc is not None and dec is not None:
        enc_tags = set().union(*(_bytes_tags_appended(f)
                                 for f in _with_helpers(index, enc)))
        dec_tags = set().union(*(_bytes_tags_compared(f, "tag")
                                 for f in _with_helpers(index, dec)))
        if enc_tags and dec_tags:
            for tag in sorted(enc_tags - dec_tags):
                findings.append(Finding(
                    "GL006", module.relpath, enc.lineno, enc.col_offset,
                    f"wire tag {tag!r} is encoded by `_enc` but `_dec` has "
                    f"no decode arm; round-trips of values carrying it "
                    f"raise WireError", scope=module.scope_at(enc)))
            for tag in sorted(dec_tags - enc_tags):
                findings.append(Finding(
                    "GL006", module.relpath, dec.lineno, dec.col_offset,
                    f"wire tag {tag!r} has a decode arm in `_dec` but is "
                    f"never encoded; dead arm or a missing encoder branch",
                    scope=module.scope_at(dec)))

    # -- frame-version-before-length (gated on _FRAME_VERSION existing) -----
    has_version = any(
        isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_FRAME_VERSION"
            for t in n.targets)
        for n in module.tree.body)
    if has_version:
        all_fns = list(index.module_funcs.values()) \
            + list(index.methods.values())
        for fn in all_fns:
            unpacks_hdr = any(
                isinstance(c, ast.Call)
                and callgraph.last_attr(c.func) == "unpack"
                and "HDR" in (callgraph.dotted_name(c.func) or "").upper()
                for c in callgraph.calls_under(fn))
            if not unpacks_hdr:
                continue
            refs_version = any(
                isinstance(n, ast.Name) and n.id == "_FRAME_VERSION"
                for n in callgraph.walk(fn))
            if not refs_version:
                findings.append(Finding(
                    "GL006", module.relpath, fn.lineno, fn.col_offset,
                    f"`{fn.name}` unpacks the frame header without checking "
                    f"_FRAME_VERSION; version validation must precede "
                    f"payload-length parsing (route through _frame_len)",
                    scope=module.scope_at(fn)))
    return findings
