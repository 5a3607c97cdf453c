"""Plain primitives the reference models share: bilinear sampling in pixel
coordinates (zeros padding), the flow-displaced local correlation, resizes,
the separable Gaussian, SSIM's loss, and the NHWC conv of DCMCS3DI's
layers. Channel-last throughout: images (B, H, W, C), flows (B, H, W, 2)
holding (dx, dy)."""

import math

import numpy as np
import torch
import torch.nn.functional as F


def coords_grid(h, w, dtype=torch.float32, device=None):
    """(H, W, 2) pixel coordinates holding (x, y)."""
    y = torch.arange(h, dtype=dtype, device=device)
    x = torch.arange(w, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def grid_sample(img, coords):
    """Bilinear sample of ``img`` (B, H, W, C) at ``coords`` (B, ..., 2),
    zeros outside: positions clamped into [-1.5, S + 0.5] and read from a
    2-pixel zero band."""
    b, h, w, c = img.shape
    x = coords[..., 0].clamp(-1.5, w + 0.5)
    y = coords[..., 1].clamp(-1.5, h + 0.5)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0).unsqueeze(-1).to(img.dtype)
    wy = (y - y0).unsqueeze(-1).to(img.dtype)
    wp = w + 4
    flat = F.pad(img, (0, 0, 2, 2, 2, 2)).reshape(b, -1, c)
    start = ((y0.long() + 2) * wp + x0.long() + 2).reshape(b, -1)
    bidx = torch.arange(b, device=img.device)[:, None]
    lead = x.shape
    c00, c01, c10, c11 = (flat[bidx, start + o].reshape(lead + (c,))
                          for o in (0, 1, wp, wp + 1))
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def flow_warp(feature, flow):
    """out(p) = feature(p + flow(p)), zeros padding."""
    h, w = feature.shape[1], feature.shape[2]
    return grid_sample(feature, coords_grid(h, w, flow.dtype, flow.device)[None] + flow)


def forward_backward_consistency(fwd_flow, bwd_flow, alpha=0.01, beta=0.5):
    """UnFlow's occlusion masks (occluded == 1) as (B, H, W) floats."""
    mag = torch.linalg.vector_norm(fwd_flow, dim=-1) + torch.linalg.vector_norm(bwd_flow, dim=-1)
    diff_fwd = torch.linalg.vector_norm(fwd_flow + flow_warp(bwd_flow, fwd_flow), dim=-1)
    diff_bwd = torch.linalg.vector_norm(bwd_flow + flow_warp(fwd_flow, bwd_flow), dim=-1)
    threshold = alpha * mag + beta
    return (diff_fwd > threshold).to(fwd_flow.dtype), (diff_bwd > threshold).to(fwd_flow.dtype)


def local_correlation_with_flow(feature0, feature1, flow, radius):
    """GMFlow's GRU-loop correlation: feature0[p] against feature1 sampled
    bilinearly (zeros padding) at p + flow[p] + each of the (2r+1)^2 integer
    offsets, over sqrt(C). The integer dots of the (2r+2)^2 window, one
    window row at a time, then the four-corner blend (every tap of a pixel
    shares one bilinear phase)."""
    b, h, w, c = feature0.shape
    r = radius
    k = 2 * r + 3
    pad = 2 * r + 4
    base = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    bx = base[..., 0].clamp(-(r + 2.0), w + r + 1.0)
    by = base[..., 1].clamp(-(r + 2.0), h + r + 1.0)
    x0, y0 = torch.floor(bx), torch.floor(by)
    wx = (bx - x0).reshape(b, h * w, 1, 1)
    wy = (by - y0).reshape(b, h * w, 1, 1)
    wp = w + 2 * pad
    start = ((y0.long() - r + pad) * wp + (x0.long() - r + pad)).reshape(b, h * w, 1)
    f1p = F.pad(feature1, (0, 0, pad, pad, pad, pad)).reshape(b, -1, c)
    f0 = feature0.reshape(b, h * w, c, 1)
    cols = torch.arange(k, device=feature0.device)
    bidx = torch.arange(b, device=feature0.device)[:, None, None]
    dots = torch.stack([torch.matmul(f1p[bidx, start + i * wp + cols], f0)[..., 0]
                        for i in range(k)], dim=2)  # (B, HW, k, k)
    interp = (dots[:, :, :-1, :-1] * (1 - wy) * (1 - wx) + dots[:, :, :-1, 1:] * (1 - wy) * wx
              + dots[:, :, 1:, :-1] * wy * (1 - wx) + dots[:, :, 1:, 1:] * wy * wx)
    corr = interp[:, :, :2 * r + 1, :2 * r + 1] / math.sqrt(c)
    return corr.reshape(b, h, w, (2 * r + 1) ** 2)


def _axis_resize_bilinear(x, out_size, axis, align_corners):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners:
        den = torch.full((), max(out_size - 1, 1), dtype=torch.float32, device=x.device)
        src = dst * (in_size - 1) / den
    else:
        src = ((dst + 0.5) * (in_size / out_size) - 0.5).clamp(0.0, in_size - 1)
    i0 = torch.floor(src).long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(0, in_size - 1)
    w1 = src - i0.to(torch.float32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    return (x.index_select(axis, i0) * (1.0 - w1).reshape(shape)
            + x.index_select(axis, i1) * w1.reshape(shape))


def resize_bilinear(x, out_hw, align_corners=False):
    """Bilinear resize of the two trailing axes (F.interpolate's geometry)."""
    x = _axis_resize_bilinear(x, out_hw[0], x.ndim - 2, align_corners)
    return _axis_resize_bilinear(x, out_hw[1], x.ndim - 1, align_corners)


def resize_nearest(x, out_hw):
    """Nearest resize of the two trailing axes: src = floor(dst * in / out)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    iy = torch.clamp((torch.arange(out_hw[0], device=x.device) * in_h) // out_hw[0], max=in_h - 1)
    ix = torch.clamp((torch.arange(out_hw[1], device=x.device) * in_w) // out_hw[1], max=in_w - 1)
    return x.index_select(x.ndim - 2, iy).index_select(x.ndim - 1, ix)


def upsample_flow_bilinear(flow, factor):
    """align_corners resize of a (B, H, W, 2) flow by ``factor``, its
    magnitude scaled by the same factor."""
    h, w = flow.shape[-3], flow.shape[-2]
    out = (int(round(h * factor)), int(round(w * factor)))
    moved = resize_bilinear(torch.movedim(flow, -1, -3), out, align_corners=True) * factor
    return torch.movedim(moved, -3, -1)


def derive_matcher_size(h, w, max_area=500 * 900, multiple=32):
    """The matcher's resolution: (h, w) rounded up to multiples of 32, capped
    at the aspect-preserving size of ``max_area`` (1080x1920 -> 512x896)."""
    def up(v):
        return int(-(-v // multiple) * multiple)

    aspect = w / h
    max_h = int((max_area / aspect) ** 0.5)
    cap = (up(max_h), up(int(max_h * aspect)))
    size = (up(h), up(w))
    return cap if size[0] * size[1] > cap[0] * cap[1] else size


def gaussian_taps(size, sigma):
    """torchvision's normalised 1-D Gaussian as Python floats."""
    half = (size - 1) * 0.5
    x = np.linspace(-half, half, size, dtype=np.float32)
    pdf = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    return (pdf / pdf.sum(dtype=np.float32)).tolist()


def reflect_pad(x, pad):
    """Reflect padding (the edge not repeated) of the two trailing axes."""
    for axis in (x.ndim - 2, x.ndim - 1):
        n = x.shape[axis]
        idx = torch.arange(-pad, n + pad, device=x.device).abs()
        x = x.index_select(axis, torch.where(idx > n - 1, 2 * (n - 1) - idx, idx))
    return x


def separable_valid(x, taps_h, taps_w):
    """A separable filter of the two trailing axes as shifted multiply-adds,
    rows then columns, no padding."""
    h = x.shape[-2] - len(taps_h) + 1
    out = sum(tap * x[..., k:k + h, :] for k, tap in enumerate(taps_h))
    w = out.shape[-1] - len(taps_w) + 1
    return sum(tap * out[..., :, k:k + w] for k, tap in enumerate(taps_w))


def filter3x3(x, kernel):
    """3x3 cross-correlation of the two trailing axes, zero 'same' padding,
    zero taps skipped."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    return sum(kernel[a][b] * xp[..., a:a + h, b:b + w]
               for a in range(3) for b in range(3) if kernel[a][b])


def ssim_loss(x, y, window=11, sigma=1.5):
    """kornia's ssim_loss on (B, H, W, C) in [0, 1]: reflect-same Gaussian
    moments (from globally centred signals), mean of clamp((1 - map) / 2)."""
    x, y = torch.movedim(x, -1, 1), torch.movedim(y, -1, 1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    taps = gaussian_taps(window, sigma)

    def blur(t):
        return separable_valid(reflect_pad(t, window // 2), taps, taps)

    a = x.mean(dim=(-2, -1), keepdim=True)
    b = y.mean(dim=(-2, -1), keepdim=True)
    xc, yc = x - a, y - b
    mu_xc, mu_yc = blur(xc), blur(yc)
    mu_x, mu_y = mu_xc + a, mu_yc + b
    sxx = blur(xc * xc) - mu_xc ** 2
    syy = blur(yc * yc) - mu_yc ** 2
    sxy = blur(xc * yc) - mu_xc * mu_yc
    smap = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * (
        (2 * sxy + c2) / (sxx + syy + c2))
    return torch.clamp((1.0 - smap) * 0.5, 0.0, 1.0).mean()
