"""Device ms a frame inside the matcher (``models/gmflow.py``'s GMFlow, the
``matcher`` submodule of DMSCT): a CUDA-event span around each of its
calls, summed over the window, over the frames served. The span includes
the host's enqueue gaps between its kernels."""

SPANS = {"matcher": ("module", "matcher")}


def read(run):
    if not run.spans.get("matcher"):
        return None
    return run.spans["matcher"] / run.units
