"""Check modules; importing this package populates the registry.

Each module registers with :func:`autodist_tpu_torch.analysis.core.register`
(per-module checks) or :func:`~autodist_tpu_torch.analysis.core.register_program`
(whole-program checks over the
:class:`~autodist_tpu_torch.analysis.program.ProgramIndex`). Check ownership:

- concurrency:      GL001 lock-held-across-dispatch (program),
                    GL002 lock-order (program), GL005 unbounded-blocking
- donation:         GL003 use-after-donate
- tracer:           GL004 tracer leak
- wire_protocol:    GL006 opcode/tag exhaustiveness + frame-version order
- envflags:         GL007 AUTODIST_* flag registry
- testlayout:       GL008 tier-1 test-window conventions
- metrics_registry: GL009 metric/event-name registry (program)
- resources:        GL010 resource-close discipline (program)
- wire_idempotency: GL011 wire-retry idempotency contract (program)
- races:            GL012 guarded-field consistency (program)
"""

from autodist_tpu_torch.analysis.checks import (  # noqa: F401
    concurrency, donation, envflags, metrics_registry, races, resources,
    testlayout, tracer, wire_idempotency, wire_protocol)
