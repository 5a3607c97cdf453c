"""Device ms a frame in DCMCS3DI's parallax attention on the materialised
matcher, the route a batch whose volumes fit on its card takes
(``run/modules.py::materialised_matcher_fits``): CUDA-event spans around the
``matcher`` submodule (its residual head, the Q/K convs and both
(B, H, W, W) cost volumes), its value conv, ``models/pasm.py``'s ``output``
(both softmaxes and the valid mask's column sums) and each ``warp`` (the
features' and the image's), summed over the window, over the frames served.
A window on the row-attention route calls no ``matcher`` and reads nothing."""

SPANS = {"dc_cost": ("module", "matcher"),
         "dc_value": ("module", "matcher.value"),
         "dc_softmax": ("function", ("color_transfer_tpu_torch.models.pasm", "output")),
         "dc_warp": ("function", ("color_transfer_tpu_torch.models.pasm", "warp"))}


def read(run):
    if not run.spans.get("dc_cost"):
        return None
    return sum(run.spans.get(name, 0.0) for name in SPANS) / run.units
