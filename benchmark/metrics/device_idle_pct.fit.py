"""The device's idle share of the traced window around the one-card training step;
see ``benchmark/readers.py::idle_pct``."""

from benchmark.readers import idle_pct as read  # noqa: F401
