"""B1's share of its roofline (``ops/local_corr.py`` -> ``csrc/local_corr.cu``,
the GRU loop's flow-displaced correlation): the least time of every call the
window made, from the shapes of its arguments (``peaks.local_corr_bound_s``:
the bytes bound it at the served shape), over the device time of the
``local_corr_kernel`` launches in the trace."""

from benchmark.peaks import local_corr_bound_s

SPANS = {"b1": ("function", ("color_transfer_tpu_torch.models.gmflow",
                             "local_correlation_with_flow"))}
RADIUS = 4  # GMFlow's refinement radius


def read(run):
    calls = run.span_shapes.get("b1")
    kernel_us = sum(e - s for name, s, e in run.digest["device_events"]
                    if "local_corr_kernel" in name)
    if not calls or kernel_us <= 0:
        return None
    least_s = sum(local_corr_bound_s(*shapes[0], RADIUS) for shapes in calls)
    return 100.0 * least_s / (kernel_us / 1e6)
