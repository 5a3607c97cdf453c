"""sRGB <-> CIE Lab (D65 / 2 degree observer), channel-last — port of the
part of color_transfer_tpu/core/colorspace.py that the classical methods
run (Reinhard's Lab statistics). The constants are the JAX package's numpy
arrays; the ``1e-12`` guards on the fractional powers are kept.

torch has no ``cbrt``: the Lab companding takes ``pow(1/3)`` of the
guarded positive value, which differs from a correctly rounded cube root
by up to about one float32 ulp (the parity tests hold Lab to 2e-4 in L's
0-100 units).

The 3x3 colour matrices are plain matmuls: float32 on the card as long as
cuBLAS's TF32 is off (``core/precision.py``).
"""

import numpy as np
import torch

# skimage's xyz_from_rgb (CIE RGB -> XYZ under D65).
_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ_TO_RGB = np.linalg.inv(_RGB_TO_XYZ)
# D65 / 2 degree reference white, as used by skimage and kornia.
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)
_LAB_DELTA = 6.0 / 29.0
_LAB_T0 = _LAB_DELTA**3


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _matmul3(x, m):
    """(..., 3) @ m^T."""
    return torch.matmul(x, _const(m, x).T)


def srgb_to_linear(s):
    """sRGB electro-optical transfer function (gamma expand)."""
    safe = torch.clamp_min((s + 0.055) / 1.055, 1e-12)
    return torch.where(s <= 0.04045, s / 12.92, safe**2.4)


def linear_to_srgb(lin):
    """Inverse sRGB EOTF (gamma compress)."""
    safe = torch.clamp_min(lin, 1e-12)
    return torch.where(lin <= 0.0031308, 12.92 * lin, 1.055 * safe ** (1 / 2.4) - 0.055)


def rgb_to_xyz(rgb):
    return _matmul3(srgb_to_linear(rgb), _RGB_TO_XYZ)


def xyz_to_rgb(xyz):
    return linear_to_srgb(_matmul3(xyz, _XYZ_TO_RGB))


def _lab_f(t):
    safe = torch.clamp_min(t, 1e-12)
    return torch.where(t > _LAB_T0, safe.pow(1.0 / 3.0),
                       t / (3 * _LAB_DELTA**2) + 4.0 / 29.0)


def rgb_to_lab(rgb):
    """sRGB in [0, 1] -> CIE Lab (L in [0, 100])."""
    f = _lab_f(rgb_to_xyz(rgb) / _const(_D65_WHITE, rgb))
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab):
    """Inverse of :func:`rgb_to_lab`, clipped to [0, 1] like skimage."""
    L, a, b = lab.unbind(-1)
    fy = (L + 16.0) / 116.0
    f = torch.stack([a / 500.0 + fy, fy, fy - b / 200.0], dim=-1)
    xyz = torch.where(f > _LAB_DELTA, f**3, 3 * _LAB_DELTA**2 * (f - 4.0 / 29.0))
    # skimage clips negative Z from numerical noise before converting back.
    xyz = torch.clamp_min(xyz * _const(_D65_WHITE, lab), 0.0)
    return torch.clamp(xyz_to_rgb(xyz), 0.0, 1.0)


def rgb_to_hsv(rgb):
    """RGB -> HSV with H, S, V all in [0, 1] (torchvision convention)."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(maxc == 0, ones, maxc)
    cr_div = torch.where(cr == 0, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(cr == 0, torch.zeros_like(h), h)
    h = (h / 6.0) % 1.0
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    """HSV (all in [0, 1]) -> RGB, torchvision convention."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def rgb_to_grayscale(rgb, keepdims=False):
    """ITU-R 601-2 luma transform, torchvision's rgb_to_grayscale weights."""
    gray = rgb[..., 0] * 0.2989 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return gray[..., None] if keepdims else gray


_RGB_TO_YIQ = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.5959, -0.2746, -0.3213],
        [0.2115, -0.5227, 0.3112],
    ],
    dtype=np.float32,
)


def rgb_to_yiq(rgb):
    """RGB -> YIQ (NTSC), the luminance/chromatic split used by FSIMc."""
    return _matmul3(rgb, _RGB_TO_YIQ)
