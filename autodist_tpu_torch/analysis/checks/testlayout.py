"""GL008 — tier-1 test-window conventions.

The tier-1 suite runs ``pytest tests/ -m 'not slow'`` under an 870-second
budget and collects files in alphabetical order; the budget historically
expires inside ``test_multiprocess.py``. Two conventions keep that window
stable (CHANGES.md records both): new test files must be NAMED so they sort
where they intend to run (in-window, or deliberately last like
``test_unrolled.py``), and known-slow tests — anything spawning real
subprocesses — must either carry ``@pytest.mark.slow`` or live at/after the
window edge so a new subprocess-heavy file cannot silently push existing
in-window tests past the budget.

The port's tests are ``tests/test_torch_*.py``: the check covers those files
(the JAX package's own tests are its analyzer's), requires the
``test_torch_`` prefix in the name, and keeps the same window edge. Every
``test_torch_*`` name sorts after ``test_multiprocess.py``, which is why the
port's tests may spawn gloo ranks without the ``slow`` marker.
"""

import ast
import re
from typing import List

from autodist_tpu_torch.analysis import callgraph
from autodist_tpu_torch.analysis.core import (TEST_PREFIX, Context, Finding,
                                              Module, register)

_NAME_RE = re.compile(r"^test_torch_[a-z0-9_]+\.py$")
# The alphabetical point where the 870s tier-1 budget historically expires
# files sorting at/after it are outside the
# guaranteed window, so their wall-clock cost cannot displace in-window tests.
WINDOW_EDGE = "test_multiprocess.py"

_SPAWN_ATTRS = {"Popen", "run", "check_call", "check_output", "call"}


def _basename(relpath: str) -> str:
    return relpath.rsplit("/", 1)[-1]


@register("GL008", "test file violates the tier-1 window conventions")
def check_test_layout(module: Module, ctx: Context) -> List[Finding]:
    """GL008 — test-window ordering.

    For the port's ``tests/test_torch*.py`` files:

    - The filename must match ``test_torch_[a-z0-9_]+.py`` — the suite's ordering
      IS its schedule (files collect alphabetically against the 870s tier-1
      budget), so a stray uppercase/hyphen name lands at an unintended
      position.
    - A file sorting BEFORE the window edge (``test_multiprocess.py``) that
      spawns real subprocesses (``subprocess.Popen/run/...`` or the
      ``mp_env`` multi-process harness) must mark those tests
      ``@pytest.mark.slow``: subprocess tests cost tens of seconds each,
      and an unmarked one inside the window displaces existing in-window
      tests past the budget. (Pre-existing files are grandfathered via the
      committed baseline — marking them slow NOW would remove them from
      tier-1 and change the pass count.)
    - ``pytest.mark.slow`` requires the ``slow`` marker registered in
      pyproject.toml — an unregistered marker is a typo trap (``-m 'not
      slow'`` silently matches nothing).
    """
    base = _basename(module.relpath)
    if module.tree is None \
            or not module.relpath.startswith(TEST_PREFIX.rstrip("_")):
        return []
    findings: List[Finding] = []

    if not _NAME_RE.match(base):
        findings.append(Finding(
            "GL008", module.relpath, 1, 0,
            f"test filename {base!r} does not match test_torch_[a-z0-9_]+.py; "
            f"alphabetical position decides whether it runs inside the "
            f"870s tier-1 window — name it deliberately"))

    spawn_line = None
    imports_mp_env = False
    for node in callgraph.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "mp_env" or alias.name.endswith(".mp_env"):
                    imports_mp_env = True
                    spawn_line = spawn_line or node.lineno
        elif isinstance(node, ast.ImportFrom):
            # Both import forms the repo uses: `from mp_env import ...` and
            # `from tests.mp_env import ...`.
            mod = node.module or ""
            if mod == "mp_env" or mod.endswith(".mp_env"):
                imports_mp_env = True
                spawn_line = spawn_line or node.lineno
        elif isinstance(node, ast.Call):
            dotted = callgraph.dotted_name(node.func) or ""
            if dotted.startswith("subprocess.") \
                    and dotted.rsplit(".", 1)[-1] in _SPAWN_ATTRS:
                spawn_line = spawn_line or node.lineno

    has_slow = any(
        callgraph.dotted_name(node) == "pytest.mark.slow"
        for node in callgraph.walk(module.tree))

    if spawn_line is not None and base < WINDOW_EDGE and not has_slow:
        kind = "the mp_env multi-process harness" if imports_mp_env \
            else "subprocess"
        findings.append(Finding(
            "GL008", module.relpath, spawn_line, 0,
            f"file sorts inside the tier-1 window (before {WINDOW_EDGE}) "
            f"and spawns {kind} without @pytest.mark.slow; subprocess "
            f"tests displace in-window tests past the 870s budget"))

    if has_slow and "slow" not in ctx.pyproject_markers():
        line = next((n.lineno for n in callgraph.walk(module.tree)
                     if callgraph.dotted_name(n) == "pytest.mark.slow"), 1)
        findings.append(Finding(
            "GL008", module.relpath, line, 0,
            "pytest.mark.slow used but the `slow` marker is not registered "
            "in pyproject.toml [tool.pytest.ini_options] markers"))
    return findings
