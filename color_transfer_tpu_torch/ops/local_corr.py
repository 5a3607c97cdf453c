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
    header for what bounds it and how it is laid out): a block owns a tile
    of output pixels and stages the bounding box of their windows in shared
    memory when it fits ``launch_plan``'s budget, else takes each pixel
    with one warp; ``tile_boxes`` states its per-tile choice.

``corr_dtype`` is the JAX package's knob: both features are cast to it
first. float32 (the default) is the bit-strict route; bfloat16 is the TPU
kernel's MXU variant (``_mxu_group_kernel``): the features rounded to bf16,
their products formed in f32 (exact for bf16 x bf16) and summed in f32, the
bilinear epilogue and the output f32. The kernel has an instantiation for
each.

``local_correlation_with_flow`` routes by device: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. The counter
``local_corr.launches`` (utils/profiling.py) counts kernel launches,
``local_corr.bf16_launches`` those of the bf16 instantiation.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.core.sampling import coords_grid
from color_transfer_tpu_torch.utils import profiling

# csrc/local_corr.cu's limits: radius 0-4 (one instantiation each), C a
# multiple of 4 (f32) or 8 (bf16: a 16-byte vector) up to 256, slices of
# 128 bytes a position (32 f32 or 64 bf16 channels), a tile of 32 or 64
# pixels, at most 3 stages.
MAX_RADIUS, MAX_CHANNELS, SLICE_BYTES, MAX_TILE_PX = 4, 256, 128, 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Shared memory of one H100 SM (233,472 bytes), 1 KB of it reserved for
# each block, the rest shared by the blocks on the SM; one block takes at
# most 227 KB. The kernel's own static arrays (window starts, phases,
# states, the box: 1,296 bytes) with a margin.
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM_LIMIT, KERNEL_STATIC = 233472, 1024, 227 * 1024, 1536


class CorrPlan(NamedTuple):
    """csrc/local_corr.cu's launch: tile_h x tile_w output pixels a block,
    ``threads`` a block, ``slice`` channels a stage, ``stages`` stages of
    ``budget`` box positions (plus the tile's f0) each, ``smem`` bytes of
    dynamic shared memory."""

    tile_h: int
    tile_w: int
    threads: int
    slice: int
    stages: int
    budget: int
    smem: int


# The launch: 8 x 8 output tiles, two stages (a slice's copy overlaps the
# previous one's dots), two blocks an SM (the kernel's registers, 96 a
# thread at r = 4, allow two; its shared memory is sized to match).
TILE, STAGES, BLOCKS_PER_SM = (8, 8), 2, 2


@functools.cache
def launch_plan(c, local_radius, itemsize=4):
    """The kernel's launch at C channels of ``itemsize`` bytes (4: f32, 2:
    bf16) and radius r: an 8 x 8 tile, (r + 1) threads a pixel, two stages
    of 128-byte slices (32 f32 or 64 bf16 channels), and the most box
    positions a stage can hold with two blocks on an SM. A smooth flow's
    8 x 8 tile at r = 4 needs a box of 17 x 17 = 289 positions; the budget
    leaves room for the windows' spread (the slices make it the same for
    every C and both types)."""
    if not 0 <= local_radius <= MAX_RADIUS:
        raise ValueError(f"local_radius must be in [0, {MAX_RADIUS}], got {local_radius}")
    per_vec = 16 // itemsize
    if itemsize not in (2, 4) or c % per_vec or not per_vec <= c <= MAX_CHANNELS:
        raise ValueError(f"C must be a multiple of {per_vec} in [{per_vec}, {MAX_CHANNELS}], "
                         f"got {c} ({itemsize}-byte channels)")
    th, tw = TILE
    npx = th * tw
    per_block = min(SM_SMEM // BLOCKS_PER_SM - BLOCK_RESERVED - KERNEL_STATIC,
                    BLOCK_SMEM_LIMIT - KERNEL_STATIC)
    position = SLICE_BYTES  # bytes of a box position (or a tile pixel) a stage
    budget = per_block // (STAGES * position) - MAX_TILE_PX
    k = 2 * local_radius + 2
    if budget * (position // 4) < npx * k * k:  # the f32 dots reuse the first stage
        raise ValueError("the staging budget cannot hold the tile's dots")
    return CorrPlan(th, tw, npx * (local_radius + 1), SLICE_BYTES // itemsize, STAGES,
                    budget, STAGES * (budget + MAX_TILE_PX) * position)


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
    """Plain torch version: f0/f1 (B, H, W, C) float32 or bfloat16, flow
    (B, H, W, 2) float32 -> (B, H, W, (2r+1)^2) float32. bf16 features are
    widened to f32 first: their products are exact in f32 and every sum
    runs in f32, the TPU kernel's MXU arithmetic."""
    if feature0.dtype == torch.bfloat16:
        feature0, feature1 = feature0.float(), feature1.float()
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


def window_starts(flow, local_radius):
    """The kernel's (and the plain version's) window of each pixel: the
    integer start (sx, sy) of its (2r+2)^2 taps, its bilinear phase (wx,
    wy) and whether the window touches the image (``live``)."""
    b, h, w, _ = flow.shape
    r = local_radius
    base = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    bx = base[..., 0].clamp(-(r + 2.0), w + r + 1.0)
    by = base[..., 1].clamp(-(r + 2.0), h + r + 1.0)
    x0, y0 = torch.floor(bx), torch.floor(by)
    sx, sy = x0.long() - r, y0.long() - r
    k = 2 * r + 2
    live = (sx + k - 1 >= 0) & (sx < w) & (sy + k - 1 >= 0) & (sy < h)
    return sx, sy, bx - x0, by - y0, live


def tile_boxes(flow, local_radius, plan):
    """Per tile of ``plan`` (B, tiles down, tiles across): the origin (x0,
    y0) and size (w, h) of the bounding box of its live pixels' windows
    (0 x 0 at the origin when none is live), and ``staged``: whether the
    kernel stages the box (w * h <= plan.budget) or takes each pixel with a
    warp."""
    b, h, w, _ = flow.shape
    sx, sy, _, _, live = window_starts(flow, local_radius)
    th, tw = plan.tile_h, plan.tile_w
    ty, tx = -(-h // th), -(-w // tw)
    big = 2**40

    def tiles(v, fill):  # (B, H, W) -> (B, ty, tx, th * tw), ragged edge filled
        v = torch.where(live, v, torch.full_like(v, fill))
        v = F.pad(v, (0, tx * tw - w, 0, ty * th - h), value=fill)
        return v.reshape(b, ty, th, tx, tw).permute(0, 1, 3, 2, 4).reshape(b, ty, tx, th * tw)

    k = 2 * local_radius + 2
    x_lo, y_lo = tiles(sx, big).amin(-1), tiles(sy, big).amin(-1)
    x_hi, y_hi = tiles(sx, -big).amax(-1), tiles(sy, -big).amax(-1)
    any_live = x_lo < big
    zero = torch.zeros_like(x_lo)
    box_w = torch.where(any_live, x_hi - x_lo + k, zero)
    box_h = torch.where(any_live, y_hi - y_lo + k, zero)
    return {"x0": torch.where(any_live, x_lo, zero), "y0": torch.where(any_live, y_lo, zero),
            "w": box_w, "h": box_h, "staged": box_w * box_h <= plan.budget}


def check_kernel_inputs(feature0, feature1, flow, local_radius):
    """Raise ValueError for inputs the CUDA kernel does not take: it reads
    contiguous, 16-byte aligned (B, H, W, C) features, both float32 or both
    bfloat16, with C a multiple of 4 (f32) or 8 (bf16: a 16-byte vector)
    up to 256 (``MAX_CHANNELS``), a contiguous float32 (B, H, W, 2) flow,
    and 0 <= r <= 4 (``MAX_RADIUS``)."""
    for name, t in (("feature0", feature0), ("feature1", feature1),
                    ("flow", flow)):
        want = (torch.float32,) if name == "flow" else KERNEL_DTYPES
        if t.dtype not in want:
            raise ValueError(f"{name}: {' or '.join(map(str, want))} required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if name != "flow" and t.data_ptr() % 16:  # features are read as float4
            raise ValueError(f"{name}: data must be 16-byte aligned")
        if t.ndim != 4:
            raise ValueError(f"{name}: (B, H, W, *) required, got {tuple(t.shape)}")
    b, h, w, c = feature0.shape
    if feature1.shape != feature0.shape or feature1.dtype != feature0.dtype:
        raise ValueError(
            f"feature1 {tuple(feature1.shape)} {feature1.dtype} != feature0 "
            f"{tuple(feature0.shape)} {feature0.dtype}"
        )
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow must be {(b, h, w, 2)}, got {tuple(flow.shape)}")
    per_vec = 16 // feature0.element_size()
    if c % per_vec or not per_vec <= c <= MAX_CHANNELS:
        raise ValueError(f"C must be a multiple of {per_vec} in [{per_vec}, {MAX_CHANNELS}], "
                         f"got {c}")
    if not 0 <= local_radius <= MAX_RADIUS:
        raise ValueError(f"local_radius {local_radius} out of range [0, {MAX_RADIUS}]")
    if max(h, w) >= 2**24 or -(-h // TILE[0]) >= 2**16 or b >= 2**16:
        raise ValueError(f"features {tuple(feature0.shape)} too large for the launch grid")


def _launch(feature0, feature1, flow, local_radius, routes=False):
    """Launch the kernel as ``launch_plan`` sizes it. ``routes``: also
    return the kernel's route of each tile (B, tiles down, tiles across;
    1 staged, 0 per pixel)."""
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
    bf16 = feature0.dtype == torch.bfloat16
    fn = lib.local_corr_forward_bf16 if bf16 else lib.local_corr_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    b, h, w, c = feature0.shape
    plan = launch_plan(c, local_radius, feature0.element_size())
    out = torch.empty(
        (b, h, w, (2 * local_radius + 1) ** 2), dtype=torch.float32,
        device=feature0.device,
    )
    tiles = None
    if routes:
        tiles = torch.empty((b, -(-h // plan.tile_h), -(-w // plan.tile_w)),
                            dtype=torch.uint8, device=feature0.device)
    with torch.cuda.device(feature0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            feature0.data_ptr(), feature1.data_ptr(), flow.data_ptr(),
            out.data_ptr(), None if tiles is None else tiles.data_ptr(),
            b, h, w, c, local_radius, plan.tile_h, plan.tile_w, plan.slice,
            plan.stages, plan.budget, plan.smem, math.sqrt(c), stream,
        )
    if err != 0:
        raise RuntimeError(f"local_corr_forward launch failed: CUDA error {err}")
    profiling.count("local_corr.launches")
    if bf16:
        profiling.count("local_corr.bf16_launches")
    return (out, tiles) if routes else out


def local_correlation_with_flow(feature0, feature1, flow, local_radius,
                                corr_dtype=torch.float32):
    """GMFlow's refinement correlation: f0/f1 (B, H, W, C), flow (B, H, W, 2)
    -> (B, H, W, (2r+1)^2) float32, the features cast to ``corr_dtype``
    (float32 or bfloat16) first, as the JAX package casts them. CPU tensors
    take the plain torch version; CUDA tensors run the hand-written kernel
    (csrc/local_corr.cu) of that type, with no fallback: a failed build or
    launch raises."""
    if corr_dtype not in KERNEL_DTYPES:
        raise ValueError(f"corr_dtype must be float32 or bfloat16, got {corr_dtype}")
    feature0, feature1 = feature0.to(corr_dtype), feature1.to(corr_dtype)
    if feature0.device.type == "cpu":
        return local_correlation_with_flow_plain(
            feature0, feature1, flow, local_radius
        )
    if feature0.device.type != "cuda":
        raise ValueError(f"unsupported device {feature0.device}")
    return _launch(feature0, feature1, flow, local_radius)
