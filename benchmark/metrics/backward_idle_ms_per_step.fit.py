"""Device idle ms a training step while the host was inside the backward
(``run/modules.py``'s span ``train.backward``; autograd's own thread works
inside its host interval): the gaps in the union of the window's device
intervals under it, over the steps."""

from benchmark import program_trace


def read(run):
    ms = program_trace.idle_ms(run, "train.backward")
    return None if ms is None else ms / run.units
