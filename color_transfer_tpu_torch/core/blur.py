"""Separable Gaussian blur with torchvision semantics — port of
color_transfer_tpu/core/blur.py.

The kernel is torchvision's: the continuous Gaussian pdf sampled at integer
offsets, normalised to sum 1, reflect padding (no edge repeat), applied
separably. The blur runs as shifted multiply-adds (rows, then columns),
the JAX package's path for ``kh * kw <= 512``, with the same taps in the
same order. JAX takes a one-channel convolution for larger kernels; the
port keeps the shift-add form there too (the same sums, so the two agree
to rounding) and never hands a one-channel conv to cuDNN, whose TF32 and
algorithm choice would change the numbers.
"""

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size, sigma, dtype=torch.float32):
    """torchvision's _get_gaussian_kernel1d: the normalised pdf (CPU)."""
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=dtype)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    return pdf / pdf.sum()


def _reflect_indices(n, pad, device):
    """Source index of each padded position along an axis of size ``n``:
    numpy's "reflect" (the edge sample is not repeated)."""
    idx = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _reflect_pad_hw(x, pad_h, pad_w):
    """Reflect padding of the two trailing axes."""
    h, w = x.shape[-2], x.shape[-1]
    if pad_h:
        x = x.index_select(x.ndim - 2, _reflect_indices(h, pad_h, x.device))
    if pad_w:
        x = x.index_select(x.ndim - 1, _reflect_indices(w, pad_w, x.device))
    return x


def gaussian_blur(x, kernel_size=11, sigma=2.0, channel_last=False):
    """Gaussian blur over the spatial axes.

    Args:
      x: ``(..., H, W)`` tensor, or ``(..., H, W, C)`` when ``channel_last``.
      kernel_size: int or (kh, kw).
      sigma: float or (sh, sw).

    Returns a tensor of the same shape (reflect-padded "same" blur).
    """
    if channel_last:
        x = torch.movedim(x, -1, -3)
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    sh, sw = (float(sigma),) * 2 if isinstance(sigma, (int, float)) else sigma
    # Taps as Python floats holding the float32 values: exact in an f32 op.
    taps_h = gaussian_kernel1d(kh, sh, x.dtype).tolist()
    taps_w = gaussian_kernel1d(kw, sw, x.dtype).tolist()
    acc = separable_valid(_reflect_pad_hw(x, kh // 2, kw // 2), taps_h, taps_w)
    if channel_last:
        acc = torch.movedim(acc, -3, -1)
    return acc


def separable_valid(x, taps_h, taps_w):
    """A separable filter over the two trailing axes, rows then columns, as
    shifted multiply-adds with no padding: (..., H, W) -> (..., H - kh + 1,
    W - kw + 1). Taps are Python floats."""
    h = x.shape[-2] - len(taps_h) + 1
    out = None
    for k, tap in enumerate(taps_h):
        term = tap * x[..., k : k + h, :]
        out = term if out is None else out + term
    w = out.shape[-1] - len(taps_w) + 1
    acc = None
    for k, tap in enumerate(taps_w):
        term = tap * out[..., :, k : k + w]
        acc = term if acc is None else acc + term
    return acc


def filter3x3(x, kernel):
    """3x3 cross-correlation of the two trailing axes with zero 'same'
    padding, tap by tap (zero taps skipped); ``kernel``: 3x3 Python floats."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for a in range(3):
        for b in range(3):
            if kernel[a][b]:
                term = kernel[a][b] * xp[..., a : a + h, b : b + w]
                out = term if out is None else out + term
    return out


def gaussian_blur_sigma_only(x, sigma, truncate=4.0, channel_last=False):
    """scipy.ndimage-style Gaussian (radius = truncate * sigma)."""
    radius = int(truncate * float(sigma) + 0.5)
    return gaussian_blur(x, 2 * radius + 1, sigma, channel_last=channel_last)
