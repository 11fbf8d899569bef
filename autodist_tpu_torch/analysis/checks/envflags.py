"""GL007 — AUTODIST_* env flags must resolve through const.py's registry.

Scattered ``os.environ.get("AUTODIST_...")`` reads made the flag surface
unenumerable: nothing could list the knobs, docs drifted, and a typo'd flag
name (``AUTODIST_PS_OVERLAP`` misspellings were the motivating near-miss)
silently fell back to the default instead of erroring. ``const.KNOWN_FLAGS``
is now the single registry; this check keeps it exhaustive.
"""

import ast
import re
from typing import List

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (CONST_PATH, PACKAGE_PREFIX, Context,
                                              Finding, Module, register)

_FLAG_RE = re.compile(r"^AUTODIST_[A-Z0-9_]+$")
_ENV_READ_CALLS = {"os.environ.get", "os.getenv", "environ.get",
                   "os.environ.setdefault", "environ.setdefault"}


@register("GL007", "env flag read outside const.py / unregistered "
                   "AUTODIST_* name")
def check_env_flags(module: Module, ctx: Context) -> List[Finding]:
    """GL007 — env-flag registry.

    Two rules keeping the flag surface enumerable and typo-proof:

    - Package code (``autodist_tpu_torch/``, except ``const.py`` itself) must not
      read ``os.environ`` / ``os.getenv`` directly — add an ``ENV`` member
      (typed, defaulted, documented) and read ``const.ENV.X.val``. Passing
      the whole environment through (``dict(os.environ)`` for child
      processes) is fine; per-key reads are not.
    - Anywhere in the linted tree, a string literal that IS an AUTODIST_*
      name must appear in ``const.KNOWN_FLAGS`` — this catches typo'd flags
      in tests' spawned-process env dicts, where a misspelling silently
      tests the default behavior instead of the intended one.
      ``const.warn_unknown_autodist_flags()`` enforces the same registry at
      runtime for flags set (not read) with a typo.
    """
    if module.tree is None or module.relpath == CONST_PATH:
        return []
    findings: List[Finding] = []

    if module.relpath.startswith(PACKAGE_PREFIX):
        for node in callgraph.walk(module.tree):
            if isinstance(node, ast.Call):
                dotted = callgraph.dotted_name(node.func)
                if dotted in _ENV_READ_CALLS:
                    findings.append(Finding(
                        "GL007", module.relpath, node.lineno, node.col_offset,
                        f"direct env read `{dotted}(...)` in package code; "
                        f"add the flag to const.ENV/_ENV_DEFAULTS and read "
                        f"const.ENV.<NAME>.val so flags stay enumerable and "
                        f"typed", scope=module.scope_at(node)))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and callgraph.dotted_name(node.value) in (
                        "os.environ", "environ"):
                findings.append(Finding(
                    "GL007", module.relpath, node.lineno, node.col_offset,
                    "direct `os.environ[...]` read in package code; resolve "
                    "through const.ENV instead",
                    scope=module.scope_at(node)))

    known = ctx.known_flags()
    if known:
        for node in callgraph.walk(module.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and _FLAG_RE.match(node.value) \
                    and node.value not in known:
                findings.append(Finding(
                    "GL007", module.relpath, node.lineno, node.col_offset,
                    f"unknown flag {node.value!r} — not in const.KNOWN_FLAGS "
                    f"(typo? if intentional, register it there with a doc "
                    f"line)", scope=module.scope_at(node)))
    return findings
