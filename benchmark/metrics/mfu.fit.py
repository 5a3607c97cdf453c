"""Model FLOPs utilisation of a one-card training step; see
``benchmark/readers.py::mfu_pct``."""

from benchmark.readers import mfu_pct as read  # noqa: F401
