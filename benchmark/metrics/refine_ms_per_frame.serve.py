"""Device ms a frame in GMFlow's GRU refinements (``models/gmflow.py``: each
of the ``num_reg_refine`` iterations, B1's correlation and the update
block): the port's own span ``gmflow.refine`` (its CUDA event pair, enqueue
gaps included), summed over the window, over the frames served."""

from benchmark import program_trace


def read(run):
    ms = program_trace.device_ms(run, "gmflow.refine")
    return None if ms is None else ms / run.units
