"""Device ms a frame in GMFlow's swin transformer (``models/gmflow.py``: the
``FeatureTransformer`` call of each scale): the port's own span
``gmflow.transformer``, summed over the window, over the frames served."""

from benchmark import program_trace


def read(run):
    ms = program_trace.device_ms(run, "gmflow.transformer")
    return None if ms is None else ms / run.units
