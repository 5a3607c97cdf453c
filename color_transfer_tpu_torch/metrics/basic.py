"""PSNR and SSIM with piq / kornia semantics — port of
color_transfer_tpu/metrics/basic.py.

  * ``ssim`` (piq.ssim): pre-downsample by ``f = max(1, round(min(H, W) /
    256))`` average pooling, Gaussian window 11 / 1.5, *valid* filtering,
    per-image mean then batch mean.
  * ``ssim_loss`` (kornia.losses.ssim_loss): no downsampling, the same
    window, *same* filtering with reflect padding; mean((1 - map) / 2)
    clamped to [0, 1]. DMSCT's training loss.

The Gaussian runs as shifted multiply-adds (rows, then columns), as
``core/blur.py`` does, never as a one-channel cuDNN convolution. Inputs are
channel-last ``(B, H, W, C)`` in [0, 1].
"""

import torch

from color_transfer_tpu_torch.core.blur import (
    _reflect_pad_hw,
    gaussian_kernel1d,
    separable_valid,
)
from color_transfer_tpu_torch.core.resize import avg_pool2d


def psnr(x, y, data_range=1.0, eps=1e-10):
    """Peak signal-to-noise ratio, averaged per image like piq.psnr."""
    mse = ((x - y) ** 2).mean(dim=tuple(range(1, x.ndim)))
    return (10.0 * torch.log10(data_range**2 / (mse + eps))).mean()


def _gaussian_filter(x, kernel_size, sigma, padding):
    """Separable Gaussian over the two trailing axes, VALID or reflect-SAME."""
    if padding == "same":
        x = _reflect_pad_hw(x, kernel_size // 2, kernel_size // 2)
    taps = gaussian_kernel1d(kernel_size, sigma, x.dtype).tolist()
    return separable_valid(x, taps, taps)


def _ssim_map(x, y, kernel_size, kernel_sigma, data_range, k1, k2, padding):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # Moments from globally centred signals (shift-invariant for the sigma
    # terms), as the JAX package computes them to keep f32 precision.
    a = x.mean(dim=(-2, -1), keepdim=True)
    b = y.mean(dim=(-2, -1), keepdim=True)
    xc, yc = x - a, y - b

    def blur(t):
        return _gaussian_filter(t, kernel_size, kernel_sigma, padding)

    mu_xc, mu_yc = blur(xc), blur(yc)
    mu_x, mu_y = mu_xc + a, mu_yc + b
    sigma_xx = blur(xc * xc) - mu_xc**2
    sigma_yy = blur(yc * yc) - mu_yc**2
    sigma_xy = blur(xc * yc) - mu_xc * mu_yc
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return ((2.0 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * cs


def ssim(x, y, kernel_size=11, kernel_sigma=1.5, data_range=1.0, k1=0.01,
         k2=0.03, downsample=True):
    """Structural similarity, piq.ssim semantics (channel-last input)."""
    x = torch.movedim(x, -1, 1)
    y = torch.movedim(y, -1, 1)
    if downsample:
        f = max(1, round(min(x.shape[-2], x.shape[-1]) / 256))
        if f > 1:
            x, y = avg_pool2d(x, f), avg_pool2d(y, f)
    smap = _ssim_map(x, y, kernel_size, kernel_sigma, data_range, k1, k2, "valid")
    return smap.mean(dim=(1, 2, 3)).mean()


def ssim_loss(x, y, window_size=11, kernel_sigma=1.5, data_range=1.0):
    """kornia.losses.ssim_loss semantics: mean((1 - ssim_map) / 2) with
    reflect-same filtering, each term clamped to [0, 1]."""
    x = torch.movedim(x, -1, 1)
    y = torch.movedim(y, -1, 1)
    smap = _ssim_map(x, y, window_size, kernel_sigma, data_range, 0.01, 0.03, "same")
    return torch.clamp((1.0 - smap) * 0.5, 0.0, 1.0).mean()
