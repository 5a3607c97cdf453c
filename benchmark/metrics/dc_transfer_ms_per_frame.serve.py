"""Device ms a frame in DCMCS3DI's transfer net (``models/dcmcs3di.py``, the
``transfer`` submodule: the 1x1 conv over [features, warped features, valid
mask], 6 residual blocks and the two tail convs): a CUDA-event span around
each of its calls, summed over the window, over the frames served."""

SPANS = {"dc_transfer": ("module", "transfer")}


def read(run):
    if not run.spans.get("dc_transfer"):
        return None
    return run.spans["dc_transfer"] / run.units
