"""Package version of the port."""

__version__ = "0.1.0"
