"""Photometric distortion synthesis — port of
color_transfer_tpu/data/distortions.py: the six torchvision-style ops on
channel-last [0, 1] float images, the random-order random-magnitude
training distortion, and the 31-function test grid.

Semantics follow torchvision.transforms.functional on float tensors:
blend-based ops clamp to [0, 1]; sharpness keeps the 1-pixel border
unblurred. The random draws come from an explicit ``torch.Generator`` (the
JAX package draws from ``jax.random``, which torch cannot reproduce) or are
passed in, so a test can hand both packages the same permutation and
factors.
"""

from functools import partial

import numpy as np
import torch

from color_transfer_tpu_torch.core.blur import filter3x3
from color_transfer_tpu_torch.core.colorspace import hsv_to_rgb, rgb_to_grayscale, rgb_to_hsv


def _blend(img1, img2, ratio):
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    mean = rgb_to_grayscale(img).mean(dim=(-2, -1), keepdim=True)[..., None]
    return _blend(img, mean.expand(img.shape), factor)


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_grayscale(img, keepdims=True).expand(img.shape), factor)


def adjust_hue(img, factor):
    h, s, v = rgb_to_hsv(img).unbind(-1)
    return hsv_to_rgb(torch.stack([(h + factor) % 1.0, s, v], dim=-1))


def adjust_gamma(img, gamma, gain=1.0):
    return torch.clamp(gain * torch.clamp_min(img, 0.0) ** gamma, 0.0, 1.0)


_SHARP_KERNEL = np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0


def adjust_sharpness(img, factor):
    """torchvision adjust_sharpness: blend with a fixed 3x3 blur (zero
    'same' padding) whose 1-pixel border is left equal to the input."""
    h, w = img.shape[-3], img.shape[-2]
    x = torch.movedim(img, -1, -3)  # (..., C, H, W)
    blurred = filter3x3(x, torch.as_tensor(_SHARP_KERNEL, dtype=img.dtype).tolist())
    interior = torch.zeros(h, w, dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    blurred = torch.where(interior, torch.clamp(blurred, 0.0, 1.0), x)
    return torch.movedim(_blend(x, blurred, factor), -3, -1)


def uniform_distortion_draw(generator=None, max_magnitude=0.5):
    """One draw of the training distortion: a permutation of the 6 ops and
    6 factors ~ U(1 - max, 1 + max), on the CPU (no device sync when they
    pick the ops)."""
    perm = torch.randperm(6, generator=generator)
    factors = (1.0 - max_magnitude) + 2 * max_magnitude * torch.rand(6, generator=generator)
    return perm, factors


def apply_uniform_distortions(img, generator=None, perm=None, factors=None,
                              max_magnitude=0.5):
    """Random-order random-magnitude distortion of one (H, W, 3) image
    (reference utils/data.py:25-49): brightness, contrast, saturation, gamma
    and sharpness by factors[0, 1, 2, 4, 5], hue by factors[3] - 1, applied
    in the order ``perm``. ``perm`` and ``factors`` come from
    ``uniform_distortion_draw(generator)`` unless given."""
    if perm is None or factors is None:
        perm, factors = uniform_distortion_draw(generator, max_magnitude)
    f = [float(v) for v in factors]
    ops = [
        lambda im: adjust_brightness(im, f[0]),
        lambda im: adjust_contrast(im, f[1]),
        lambda im: adjust_saturation(im, f[2]),
        lambda im: adjust_hue(im, f[3] - 1.0),
        lambda im: adjust_gamma(im, f[4]),
        lambda im: adjust_sharpness(im, f[5]),
    ]
    for i in perm:
        img = ops[int(i)](img)
    return img


def setup_grid_distortions(max_magnitude=0.5, num=6):
    """The 31-function deterministic test grid (reference utils/data.py:12-22):
    identity + 5 ops x 6 magnitudes in linspace(-max, max)."""
    fns = [lambda x: x]
    for magnitude in np.linspace(-max_magnitude, max_magnitude, num):
        m = float(magnitude)
        fns.append(partial(adjust_brightness, factor=1 + m))
        fns.append(partial(adjust_contrast, factor=1 + m))
        fns.append(partial(adjust_saturation, factor=1 + m))
        fns.append(partial(adjust_hue, factor=m))
        fns.append(partial(adjust_gamma, gamma=1 + m))
    return fns
