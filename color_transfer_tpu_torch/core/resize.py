"""Resize primitives with torch ``F.interpolate`` parity — the port of
color_transfer_tpu/core/resize.py (the subset DMSCT, the regrain pyramid
and the metrics run).

All resize functions operate on the two trailing axes of ``(..., H, W)``
tensors, exactly as the JAX versions do, and use the same float32 source
coordinate arithmetic so the two packages agree to rounding.
"""

import torch

from color_transfer_tpu_torch.core.blur import gaussian_blur


def _axis_resize_bilinear(x, out_size, axis, align_corners):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners:
        # out_size == 1: torch F.interpolate(align_corners=True) selects
        # index 0 (not the half-pixel centre the False formula would give).
        # The divisor is a tensor: on the card, division by a Python scalar
        # multiplies by its rounded reciprocal, an ulp off the CPU's (and
        # JAX's) correctly rounded quotient, and an ulp of a source
        # coordinate moves every bilinear weight of a flow resize.
        den = torch.full((), max(out_size - 1, 1), dtype=torch.float32, device=x.device)
        src = dst * (in_size - 1) / den
    else:
        scale = in_size / out_size
        src = ((dst + 0.5) * scale - 0.5).clamp(0.0, in_size - 1)
    i0 = torch.floor(src).long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(0, in_size - 1)
    w1 = src - i0.to(torch.float32)
    w0 = 1.0 - w1
    g0 = x.index_select(axis, i0)
    g1 = x.index_select(axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    return g0 * w0.reshape(shape).to(x.dtype) + g1 * w1.reshape(shape).to(x.dtype)


def resize_bilinear(x, out_hw, align_corners=False):
    """Bilinear resize of the two trailing axes, torch interpolate parity."""
    out_h, out_w = out_hw
    x = _axis_resize_bilinear(x, out_h, x.ndim - 2, align_corners)
    return _axis_resize_bilinear(x, out_w, x.ndim - 1, align_corners)


def resize_nearest(x, out_hw):
    """Nearest resize of the two trailing axes, torch 'nearest' parity
    (src index = floor(dst * in/out)); exact integer downscale factors take
    a strided slice, which selects the same elements."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2], x.shape[-1]
    if in_h % out_h == 0 and in_w % out_w == 0:
        return x[..., :: in_h // out_h, :: in_w // out_w]
    iy = torch.clamp((torch.arange(out_h, device=x.device) * in_h) // out_h,
                     max=in_h - 1)
    ix = torch.clamp((torch.arange(out_w, device=x.device) * in_w) // out_w,
                     max=in_w - 1)
    return x.index_select(x.ndim - 2, iy).index_select(x.ndim - 1, ix)


def resize_antialias(x, out_hw):
    """skimage.transform.resize parity: bilinear (align_corners=False) after
    a Gaussian anti-alias prefilter when downscaling, sigma = max(0,
    (in/out - 1) / 2) per axis and a kernel of 2 * int(4 sigma + 0.5) + 1."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2], x.shape[-1]
    sig_h = max(0.0, (in_h / out_h - 1.0) / 2.0)
    sig_w = max(0.0, (in_w / out_w - 1.0) / 2.0)
    if sig_h > 1e-8 or sig_w > 1e-8:
        sig_h, sig_w = max(sig_h, 1e-8), max(sig_w, 1e-8)
        kh = 2 * int(4.0 * sig_h + 0.5) + 1
        kw = 2 * int(4.0 * sig_w + 0.5) + 1
        x = gaussian_blur(x, (kh, kw), (sig_h, sig_w))
    return resize_bilinear(x, out_hw, align_corners=False)


def avg_pool2d(x, factor):
    """Non-overlapping average pool of the two trailing axes (torch
    ``F.avg_pool2d(kernel_size=f)`` with truncation of ragged edges)."""
    if factor == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    th, tw = (h // factor) * factor, (w // factor) * factor
    x = x[..., :th, :tw]
    x = x.reshape(*x.shape[:-2], th // factor, factor, tw // factor, factor)
    return x.mean(dim=(-3, -1))


def upsample_flow_bilinear(flow, factor):
    """Bilinear flow resize with magnitude rescale: align_corners=True resize
    of the (..., H, W, 2) field, then multiply by ``factor`` (which may be a
    fraction, e.g. 0.5 to bring flow down to a feature level)."""
    h, w = flow.shape[-3], flow.shape[-2]
    out_h, out_w = int(round(h * factor)), int(round(w * factor))
    moved = torch.movedim(flow, -1, -3)
    moved = resize_bilinear(moved, (out_h, out_w), align_corners=True) * factor
    return torch.movedim(moved, -3, -1)


def _ceil_to(v, m):
    return int(-(-v // m) * m)


def derive_matcher_size(h, w, max_area=500 * 900, padding_factor=32):
    """Static matcher-resolution policy: round (h, w) up to multiples of 32;
    if the area exceeds ``max_area``, cap at the aspect-preserving maximum
    rounded up to multiples of 32 (1080x1920 -> (512, 896))."""
    size = (_ceil_to(h, padding_factor), _ceil_to(w, padding_factor))
    aspect = w / h
    max_h = int((max_area / aspect) ** 0.5)
    max_w = int(max_h * aspect)
    cap = (_ceil_to(max_h, padding_factor), _ceil_to(max_w, padding_factor))
    if size[0] * size[1] > cap[0] * cap[1]:
        return cap
    return size
