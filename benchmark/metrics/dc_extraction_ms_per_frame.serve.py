"""Device ms a frame in DCMCS3DI's extractor (``models/dcmcs3di.py``, the
``extraction`` submodule: the stem conv and 18 residual blocks on both views
at full resolution): a CUDA-event span around each of its calls, summed over
the window, over the frames served. The span includes the host's enqueue
gaps between its kernels."""

SPANS = {"dc_extraction": ("module", "extraction")}


def read(run):
    if not run.spans.get("dc_extraction"):
        return None
    return run.spans["dc_extraction"] / run.units
