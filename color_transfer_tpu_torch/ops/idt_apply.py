"""IDT transport apply — the table interpolation that moves every projected
sample of Iterative Distribution Transfer onto the reference's quantiles.

Port of color_transfer_tpu/methods/iterative.py's ``_apply_tables_pallas``
(kernel ``_apply_kernel``), whose plain statement is
``_interp_uniform_tables`` with left = 0 and right = bins: per row (one
rotated colour axis of one frame) a table of ``bins`` values on the uniform
grid ``grid_lo + step * arange(bins)``.

Two implementations of one function:
  * ``transport_apply_plain`` — plain torch, a ``gather`` of F[i], F[i+1];
  * the CUDA kernel in csrc/idt_apply.cu (hand-written for sm_90a; its
    header says what bounds it and how it is laid out).

``transport_apply`` routes by device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel (any 2 <= bins <= 256) or
raises. The counter ``idt_apply.launches`` (utils/profiling.py) counts
kernel launches.
"""

import ctypes
import math

import torch

from color_transfer_tpu_torch.utils import profiling

MAX_BINS = 256  # csrc/idt_apply.cu kMaxBins


def transport_apply_plain(x, grid_lo, step, fp, right_edge):
    """x (..., N), fp (..., bins), grid_lo/step/right_edge (...) -> (..., N).

    ``right_edge`` is the exact last grid point (the joint data maximum);
    samples above it map to ``bins`` and samples below ``grid_lo`` to 0."""
    bins = fp.shape[-1]
    lo, st, re = grid_lo[..., None], step[..., None], right_edge[..., None]
    pos = (x - lo) / st
    # nan_to_num: a NaN position (a constant axis, step 0) reads entry 0,
    # as the kernel's fmaxf does.
    i = torch.nan_to_num(torch.floor(pos).clamp(0, bins - 2), nan=0.0).long()
    frac = pos - i.to(pos.dtype)
    v0 = torch.gather(fp, -1, i)
    v1 = torch.gather(fp, -1, i + 1)
    val = v0 * (1.0 - frac) + v1 * frac
    val = torch.where(x < lo, 0.0, val)
    return torch.where(x > re, float(bins), val)


def check_kernel_inputs(x, grid_lo, step, fp, right_edge):
    """Raise ValueError for inputs the CUDA kernel does not take: float32
    contiguous tensors on one device, x (..., N), fp (..., bins) with
    2 <= bins <= 256, and (...) grid_lo, step, right_edge, at most 65535
    rows in all."""
    tensors = {"x": x, "grid_lo": grid_lo, "step": step, "fp": fp,
               "right_edge": right_edge}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
    lead = x.shape[:-1]
    if fp.shape[:-1] != lead or not 2 <= fp.shape[-1] <= MAX_BINS:
        raise ValueError(
            f"fp must be {tuple(lead)} + (bins,) with 2 <= bins <= {MAX_BINS}, "
            f"got {tuple(fp.shape)}"
        )
    for name in ("grid_lo", "step", "right_edge"):
        if tensors[name].shape != lead:
            raise ValueError(f"{name} must be {tuple(lead)}, got {tuple(tensors[name].shape)}")
    if math.prod(lead) > 65535:
        raise ValueError("at most 65535 rows")


def _launch(x, grid_lo, step, fp, right_edge):
    check_kernel_inputs(x, grid_lo, step, fp, right_edge)
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("idt_apply").idt_apply_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    rows = math.prod(x.shape[:-1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), fp.data_ptr(), grid_lo.data_ptr(), step.data_ptr(),
                 right_edge.data_ptr(), out.data_ptr(), rows, x.shape[-1],
                 fp.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"idt_apply_forward launch failed: CUDA error {err}")
    profiling.count("idt_apply.launches")
    return out


def transport_apply(x, grid_lo, step, fp, right_edge):
    """IDT's transport apply: x (..., N), fp (..., bins), grid_lo, step,
    right_edge (...) -> (..., N). CPU tensors take the plain torch version;
    CUDA tensors run the hand-written kernel (csrc/idt_apply.cu), with no
    fallback: a failed build or launch raises."""
    if x.device.type == "cpu":
        return transport_apply_plain(x, grid_lo, step, fp, right_edge)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, grid_lo, step, fp, right_edge)
