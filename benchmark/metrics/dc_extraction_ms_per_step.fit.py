"""Device ms a training step in DCMCS3DI's extractor forward
(``models/dcmcs3di.py``, the ``extraction`` submodule: a 3x3 conv and 18
residual blocks on both views): a CUDA-event span around each call, over the
steps of the window."""

SPANS = {"extraction": ("module", "extraction")}


def read(run):
    if not run.spans.get("extraction"):
        return None
    return run.spans["extraction"] / run.units
