"""Bilinear sampling in pixel coordinates — the port of
color_transfer_tpu/core/sampling.py (forward paths only).

The warp is written as an explicit 4-corner gather in pixel coordinates with
the JAX package's clamp geometry, not as ``F.grid_sample``: normalising to
[-1, 1] and back can move samples near the image edges. Zeros padding:
positions are clamped into [-1.5, S + 0.5] and read from a 2-pixel zero
band, which is value-identical to torch grid_sample's zeros padding.

Layout is channel-last: images (B, H, W, C); flows (B, H, W, 2) holding
(dx, dy). The warp has no TPU kernel on the serving path (the JAX forward is
an XLA gather), so plain torch ops are its port.
"""

import torch
import torch.nn.functional as F


def coords_grid(h, w, dtype=torch.float32, device=None):
    """Pixel-coordinate grid (H, W, 2) holding (x, y) per pixel."""
    y = torch.arange(h, dtype=dtype, device=device)
    x = torch.arange(w, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def grid_sample(img, coords):
    """Bilinear zeros-padding sample of ``img`` (B, H, W, C) at pixel
    coordinates ``coords`` (B, ..., 2) holding (x, y) -> (B, ..., C)."""
    b, h, w, c = img.shape
    lead = coords.shape[:-1]
    x = coords[..., 0].clamp(-1.5, w + 0.5)
    y = coords[..., 1].clamp(-1.5, h + 0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).unsqueeze(-1).to(img.dtype)
    wy = (y - y0).unsqueeze(-1).to(img.dtype)
    wp = w + 4
    flat = F.pad(img, (0, 0, 2, 2, 2, 2)).reshape(b, -1, c)
    start = ((y0.long() + 2) * wp + x0.long() + 2).reshape(b, -1)
    bidx = torch.arange(b, device=img.device)[:, None]

    def corner(offset):
        return flat[bidx, start + offset].reshape(lead + (c,))

    top = corner(0) * (1 - wx) + corner(1) * wx
    bot = corner(wp) * (1 - wx) + corner(wp + 1) * wx
    return top * (1 - wy) + bot * wy


def flow_warp(feature, flow):
    """Backward-warp: out(p) = feature(p + flow(p)), zeros padding.

    feature (B, H, W, C), flow (B, H, W, 2). The forward of both
    ``flow_warp`` (vmapped over the batch) and ``flow_warp_batched`` in the
    JAX package: the two share one geometry (``_warp_geometry``)."""
    h, w = feature.shape[1], feature.shape[2]
    coords = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    return grid_sample(feature, coords)


def forward_backward_consistency(fwd_flow, bwd_flow, alpha=0.01, beta=0.5):
    """Occlusion masks from forward/backward flow disagreement (UnFlow
    thresholds). Flows (B, H, W, 2); returns (fwd_occ, bwd_occ) as (B, H, W)
    float tensors where occluded == 1."""
    flow_mag = (torch.linalg.vector_norm(fwd_flow, dim=-1)
                + torch.linalg.vector_norm(bwd_flow, dim=-1))
    warped_bwd = flow_warp(bwd_flow, fwd_flow)
    warped_fwd = flow_warp(fwd_flow, bwd_flow)
    diff_fwd = torch.linalg.vector_norm(fwd_flow + warped_bwd, dim=-1)
    diff_bwd = torch.linalg.vector_norm(bwd_flow + warped_fwd, dim=-1)
    threshold = alpha * flow_mag + beta
    return (
        (diff_fwd > threshold).to(fwd_flow.dtype),
        (diff_bwd > threshold).to(fwd_flow.dtype),
    )
