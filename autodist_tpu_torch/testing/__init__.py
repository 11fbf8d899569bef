"""Test harnesses of the port: deterministic fault injection (``faults``)."""
