"""The operator tools on the port, each run as ``python -m
autodist_tpu_torch.tools.<name>``: the consoles ``adtop`` (one server) and
``adfleet`` (many), ``adtrace`` (request traces across a serving fleet),
``adprof`` (profile summaries, diffs and the cost-model probe), ``tracedump``
(span dumps merged into one Chrome trace), ``graftlint`` (the static
analyzer, :mod:`autodist_tpu_torch.analysis`) and ``parallel_tests`` (the
port's tests sharded over processes). Their flags, output and exit codes are
the JAX package's ``tools/``; they read the port's own modules and touch no
device."""
