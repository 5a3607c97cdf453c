"""Device ms a frame in DMSCT's corrector (``models/dmsct.py::DMSCT.correct``:
the EfficientNet encoder on both views, the flow warps, the UNet decoder and
the head): a CUDA-event span around each call, over the frames served."""

SPANS = {"corrector": ("method", "correct")}


def read(run):
    if not run.spans.get("corrector"):
        return None
    return run.spans["corrector"] / run.units
