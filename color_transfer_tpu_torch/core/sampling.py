"""Bilinear sampling in pixel coordinates — the port of
color_transfer_tpu/core/sampling.py.

The warp is written as an explicit 4-corner gather in pixel coordinates with
the JAX package's clamp geometry, not as ``F.grid_sample``: normalising to
[-1, 1] and back can move samples near the image edges. Zeros padding:
positions are clamped into [-1.5, S + 0.5] and read from a 2-pixel zero
band, which is value-identical to torch grid_sample's zeros padding.

Layout is channel-last: images (B, H, W, C); flows (B, H, W, 2) holding
(dx, dy). The warp's forward has no TPU kernel (the JAX forward is an XLA
gather), so plain torch ops are its port. ``flow_warp_batched`` is the
JAX custom VJP's counterpart: its backward scatters the feature cotangent
through ``ops/warp_adjoint.py`` (kernel B7 on a CUDA tensor).
"""

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.ops.warp_adjoint import warp_adjoint


def coords_grid(h, w, dtype=torch.float32, device=None):
    """Pixel-coordinate grid (H, W, 2) holding (x, y) per pixel."""
    y = torch.arange(h, dtype=dtype, device=device)
    x = torch.arange(w, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _geometry(coords, h, w):
    """The zeros-padding geometry of sample positions ``coords`` (B, ..., 2)
    holding (x, y) on an (H, W) image: the clamped positions, the integer
    corner starts (y0 + 2, x0 + 2) into the 2-pixel padded image (a pair of
    (B, ...) tensors), and the bilinear fractions (the JAX package's
    ``_warp_geometry``, which stacks the starts)."""
    x = coords[..., 0].clamp(-1.5, w + 0.5)
    y = coords[..., 1].clamp(-1.5, h + 0.5)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x, y, (y0.long() + 2, x0.long() + 2), x - x0, y - y0


def _corners(img, starts):
    """The four corners of each sample in the padded image, top-left,
    top-right, bottom-left, bottom-right: img (B, H, W, C), starts a pair
    of (B, ...) tensors -> four (B, ..., C) tensors."""
    b, _, w, c = img.shape
    wp = w + 4
    flat = F.pad(img, (0, 0, 2, 2, 2, 2)).reshape(b, -1, c)
    start = (starts[0] * wp + starts[1]).reshape(b, -1)
    bidx = torch.arange(b, device=img.device)[:, None]
    lead = starts[0].shape
    return [flat[bidx, start + o].reshape(lead + (c,)) for o in (0, 1, wp, wp + 1)]


def grid_sample(img, coords):
    """Bilinear zeros-padding sample of ``img`` (B, H, W, C) at pixel
    coordinates ``coords`` (B, ..., 2) holding (x, y) -> (B, ..., C)."""
    _, _, starts, wx, wy = _geometry(coords, img.shape[1], img.shape[2])
    wx = wx.unsqueeze(-1).to(img.dtype)
    wy = wy.unsqueeze(-1).to(img.dtype)
    c00, c01, c10, c11 = _corners(img, starts)
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def flow_warp(feature, flow):
    """Backward-warp: out(p) = feature(p + flow(p)), zeros padding.

    feature (B, H, W, C), flow (B, H, W, 2). The forward of both
    ``flow_warp`` (vmapped over the batch) and ``flow_warp_batched`` in the
    JAX package: the two share one geometry (``_warp_geometry``)."""
    h, w = feature.shape[1], feature.shape[2]
    coords = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    return grid_sample(feature, coords)


def _warp_geometry(flow, h, w):
    """``_geometry`` of the warp by ``flow`` (B, H, W, 2) on an (H, W) image."""
    return _geometry(coords_grid(h, w, flow.dtype, flow.device)[None] + flow, h, w)


class _FlowWarpBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, flow):
        ctx.save_for_backward(feature, flow)
        return flow_warp(feature, flow)

    @staticmethod
    def backward(ctx, g):
        feature, flow = ctx.saved_tensors
        dfeature = dflow = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            dfeature = warp_adjoint(g, flow.contiguous())
        if ctx.needs_input_grad[1]:
            # The analytic bilinear derivative on the re-gathered corners,
            # zero where the sample position was clamped.
            h, w = feature.shape[1], feature.shape[2]
            x, y, starts, wx, wy = _warp_geometry(flow, h, w)
            p00, p01, p10, p11 = _corners(feature, starts)
            wxe, wye = wx[..., None], wy[..., None]
            ddx = (p01 - p00) * (1 - wye) + (p11 - p10) * wye
            ddy = (p10 - p00) * (1 - wxe) + (p11 - p01) * wxe
            gx = (g * ddx).sum(-1)
            gy = (g * ddy).sum(-1)
            gx = torch.where((x > -1.5) & (x < w + 0.5), gx, 0.0)
            gy = torch.where((y > -1.5) & (y < h + 0.5), gy, 0.0)
            dflow = torch.stack([gx, gy], dim=-1).to(flow.dtype)
        return dfeature, dflow


def flow_warp_batched(feature, flow):
    """Batched backward-warp, forward-identical to ``flow_warp``; its
    backward gives the feature cotangent through ``warp_adjoint`` (kernel
    B7 on a CUDA tensor, the plain scatter on a CPU one) and the flow
    cotangent in plain torch when the flow needs one (the JAX custom VJP,
    color_transfer_tpu/core/sampling.py:283-350)."""
    return _FlowWarpBatched.apply(feature, flow)


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
