"""graftlint — project-specific static analysis for autodist_tpu_torch, the
PyTorch port.

An AST-based analyzer (stdlib ``ast``/``tokenize`` only — importable with no
jax or torch present) that machine-enforces the hazard rules the JAX package
learned the hard way and the port shares: locks held across device work or
socket I/O (the collective-rendezvous deadlock class), lock-order inversions, buffer use-after-donation, tracer leaks out of
jitted functions, unbounded blocking in transport handlers, wire-protocol
opcode exhaustiveness, the ``AUTODIST_*`` env-flag registry, and the tier-1
test-window naming convention.

Entry points:

- ``python -m autodist_tpu_torch.tools.graftlint`` — the CLI (text/JSON output, ``--explain``, committed
  baseline for grandfathered findings).
- :func:`autodist_tpu_torch.analysis.core.lint_paths` — the library API the test
  suite's self-clean meta-test drives.

Checks register themselves via :func:`autodist_tpu_torch.analysis.core.register`;
importing :mod:`autodist_tpu_torch.analysis.checks` populates the registry. Inline
suppression: ``# graftlint: disable=GL001(reason)`` — the reason is mandatory
(a bare ``disable=GL001`` is itself a GL000 finding).
"""

from autodist_tpu_torch.analysis.core import (  # noqa: F401
    Context, Finding, LintResult, all_checks, lint_paths, register)
