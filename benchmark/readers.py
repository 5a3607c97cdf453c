"""What several per-layer metrics read alike: a metric file under
``metrics/`` names its own layer and takes one of these."""

from benchmark.peaks import PEAK_OPS_PER_S


def idle_pct(run):
    """The device's idle share of the traced window, in percent: 1 - busy /
    window, busy being the union of the device intervals the profiler
    recorded (kernels, copies, memsets)."""
    return 100.0 * (1.0 - run.digest["busy_s"] / run.digest["window_s"])


def mfu_pct(run):
    """Model FLOPs utilisation of the whole step, in percent: the cell's
    FLOPs a frame or a training step (``flops/<cell>.json``:
    ``peaks.reference_flops``, the plain reference at the cell's shape,
    recounted by a test; a training step counts its forward and backward, no
    recomputation; None for a cell without a count) times the window's
    rate, over the data-sheet float32 peak of the chips used (67 TFLOP/s
    each, the recipe's precision with TF32 off)."""
    if run.flops_per_unit is None:
        return None
    rate = run.units / run.window_s
    return 100.0 * run.flops_per_unit * rate / (PEAK_OPS_PER_S["f32"] * run.chips)
