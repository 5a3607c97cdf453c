"""Device ms a training step in the backward (``run/modules.py``'s
``train_step``: the span ``train.backward`` around ``total.backward()``),
summed over the window, over its steps."""

from benchmark import program_trace


def read(run):
    ms = program_trace.device_ms(run, "train.backward")
    return None if ms is None else ms / run.units
