"""Model FLOPs utilisation of a served frame; see
``benchmark/readers.py::mfu_pct``."""

from benchmark.readers import mfu_pct as read  # noqa: F401
