"""The device's idle share of the traced window around frames served (`dmsct.serve_1080p`);
see ``benchmark/readers.py::idle_pct``."""

from benchmark.readers import idle_pct as read  # noqa: F401
