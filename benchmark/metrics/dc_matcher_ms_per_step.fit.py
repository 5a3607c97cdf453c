"""Device ms a training step in DCMCS3DI's chunked training matcher
(``ops/parallax_train.py::chunked_parallax_train``, the forward call): a
CUDA-event span around each call, over the steps of the window. Its
recompute in the backward is not inside the span."""

SPANS = {"dc_matcher": ("function", ("color_transfer_tpu_torch.models.dcmcs3di",
                                     "chunked_parallax_train"))}


def read(run):
    if not run.spans.get("dc_matcher"):
        return None
    return run.spans["dc_matcher"] / run.units
