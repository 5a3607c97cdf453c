"""Model FLOPs utilisation of a data-parallel training step over the cell's four cards; see
``benchmark/readers.py::mfu_pct``."""

from benchmark.readers import mfu_pct as read  # noqa: F401
