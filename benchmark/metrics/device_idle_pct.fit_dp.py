"""The device's idle share of the traced window around the data-parallel training step (`dmsct.fit_dp4`, rank 0's card);
see ``benchmark/readers.py::idle_pct``."""

from benchmark.readers import idle_pct as read  # noqa: F401
