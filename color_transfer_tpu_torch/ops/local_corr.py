"""Flow-displaced local correlation — GMFlow's GRU-loop correlation.

For every pixel p, correlate feature0[p] with a (2r+1)^2 window of feature1
sampled bilinearly (zeros padding) at ``p + flow[p] + offset``, divided by
sqrt(C). Port of color_transfer_tpu/ops/local_corr.py
(``local_correlation_with_flow_pallas``) whose plain statement is
``_local_correlation_with_flow_xla`` in color_transfer_tpu/models/gmflow.py.

Two implementations of one function:
  * ``local_correlation_with_flow_plain`` — plain torch, the JAX XLA path's
    row scan: one (B, HW, k, C) row gather per window row, so live memory
    stays O(B*HW*k*C) (the full (B, HW, k, k, C) patch gather would be
    3.5 GB at the 1080p matcher shape).
  * the CUDA kernel in csrc/local_corr.cu (hand-written for sm_90a; see its
    header for what bounds it and how it is laid out).

``local_correlation_with_flow`` routes by device: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. Its
``launches`` attribute counts kernel launches.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.core.sampling import coords_grid

_WARPS_PER_BLOCK = 8  # csrc/local_corr.cu kWarpsPerBlock
_SMEM_LIMIT = 48 * 1024  # static-launch shared memory without opt-in


def _bilinear_epilogue(dots, wx, wy, r, c):
    """4-corner interpolation on the (k, k) integer-dot grid (all taps share
    one bilinear phase), crop to (2r+1)^2, scale by 1/sqrt(C)."""
    d00 = dots[:, :, :-1, :-1]
    d01 = dots[:, :, :-1, 1:]
    d10 = dots[:, :, 1:, :-1]
    d11 = dots[:, :, 1:, 1:]
    interp = (
        d00 * (1 - wy) * (1 - wx)
        + d01 * (1 - wy) * wx
        + d10 * wy * (1 - wx)
        + d11 * wy * wx
    )
    corr = interp[:, :, : 2 * r + 1, : 2 * r + 1]
    return corr.reshape(dots.shape[0], -1, (2 * r + 1) ** 2) / math.sqrt(c)


def local_correlation_with_flow_plain(feature0, feature1, flow, local_radius):
    """Plain torch version: f0/f1 (B, H, W, C), flow (B, H, W, 2) ->
    (B, H, W, (2r+1)^2), all float32."""
    b, h, w, c = feature0.shape
    r = local_radius
    k = 2 * r + 3  # the window plus the +1 bilinear corner on each side
    pad = 2 * r + 4
    base = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    # Clamp far-out positions into the all-zeros padding band: within
    # [-(r+2), S+r+1] nothing changes, beyond it every tap reads zero.
    bx = base[..., 0].clamp(-(r + 2.0), w + r + 1.0)
    by = base[..., 1].clamp(-(r + 2.0), h + r + 1.0)
    x0 = torch.floor(bx)
    y0 = torch.floor(by)
    wx = (bx - x0).reshape(b, h * w, 1, 1)
    wy = (by - y0).reshape(b, h * w, 1, 1)
    wp = w + 2 * pad
    start = ((y0.long() - r + pad) * wp + (x0.long() - r + pad)).reshape(
        b, h * w, 1
    )
    f1p = F.pad(feature1, (0, 0, pad, pad, pad, pad)).reshape(b, -1, c)
    f0 = feature0.reshape(b, h * w, c, 1)
    cols = torch.arange(k, device=feature0.device)
    bidx = torch.arange(b, device=feature0.device)[:, None, None]
    rows = []
    for i in range(k):  # one window row at a time bounds the gather buffer
        patch = f1p[bidx, start + i * wp + cols]  # (B, HW, k, C)
        rows.append(torch.matmul(patch, f0)[..., 0])
    dots = torch.stack(rows, dim=2)  # (B, HW, k, k)
    return _bilinear_epilogue(dots, wx, wy, r, c).reshape(
        b, h, w, (2 * r + 1) ** 2
    )


def check_kernel_inputs(feature0, feature1, flow, local_radius):
    """Raise ValueError for inputs the CUDA kernel does not take: it reads
    contiguous, 16-byte aligned float32 (B, H, W, C) features with C a
    multiple of 4 up to 256, a contiguous float32 (B, H, W, 2) flow, and
    0 <= r with its
    (2r+3)^2 dots per warp inside 48 KB of shared memory."""
    for name, t in (("feature0", feature0), ("feature1", feature1),
                    ("flow", flow)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if name != "flow" and t.data_ptr() % 16:  # features are read as float4
            raise ValueError(f"{name}: data must be 16-byte aligned")
        if t.ndim != 4:
            raise ValueError(f"{name}: (B, H, W, *) required, got {tuple(t.shape)}")
    b, h, w, c = feature0.shape
    if feature1.shape != feature0.shape:
        raise ValueError(
            f"feature1 {tuple(feature1.shape)} != feature0 {tuple(feature0.shape)}"
        )
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow must be {(b, h, w, 2)}, got {tuple(flow.shape)}")
    if c % 4 or not 4 <= c <= 256:
        raise ValueError(f"C must be a multiple of 4 in [4, 256], got {c}")
    k = 2 * local_radius + 3
    if local_radius < 0 or 4 * _WARPS_PER_BLOCK * k * k > _SMEM_LIMIT:
        raise ValueError(f"local_radius {local_radius} out of range")
    if b * h * w * k * k >= 2**31:
        raise ValueError("too many pixels for 32-bit indexing")


def _launch(feature0, feature1, flow, local_radius):
    if not (feature0.device == feature1.device == flow.device):
        raise ValueError("feature0, feature1 and flow must share one device")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (feature0, feature1, flow)
    ):
        raise RuntimeError(
            "local_correlation_with_flow: the CUDA kernel is forward-only; "
            "run it under torch.no_grad()"
        )
    check_kernel_inputs(feature0, feature1, flow, local_radius)
    from color_transfer_tpu_torch.ops import _build

    lib = _build.load("local_corr")
    fn = lib.local_corr_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    b, h, w, c = feature0.shape
    out = torch.empty(
        (b, h, w, (2 * local_radius + 1) ** 2), dtype=torch.float32,
        device=feature0.device,
    )
    with torch.cuda.device(feature0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            feature0.data_ptr(), feature1.data_ptr(), flow.data_ptr(),
            out.data_ptr(), b, h, w, c, local_radius, math.sqrt(c), stream,
        )
    if err != 0:
        raise RuntimeError(f"local_corr_forward launch failed: CUDA error {err}")
    local_correlation_with_flow.launches += 1
    return out


def local_correlation_with_flow(feature0, feature1, flow, local_radius):
    """GMFlow's refinement correlation: f0/f1 (B, H, W, C), flow (B, H, W, 2)
    -> (B, H, W, (2r+1)^2). CPU tensors take the plain torch version; CUDA
    tensors run the hand-written kernel (csrc/local_corr.cu), with no
    fallback: a failed build or launch raises."""
    if feature0.device.type == "cpu":
        return local_correlation_with_flow_plain(
            feature0, feature1, flow, local_radius
        )
    if feature0.device.type != "cuda":
        raise ValueError(f"unsupported device {feature0.device}")
    return _launch(feature0, feature1, flow, local_radius)


local_correlation_with_flow.launches = 0
