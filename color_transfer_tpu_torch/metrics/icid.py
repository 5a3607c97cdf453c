"""Improved color-image-difference (iCID) — port of
color_transfer_tpu/metrics/icid.py (Preiss et al., IEEE TIP 2014, as the
reference's MATLAB translation computes it): optional bilinear downsampling
by ``f = round(min(H, W) / 256)``, Lab, 11x11 sigma-2 Gaussian local
moments (reflect padding), seven similarity maps with the intent's weights,
prediction 1 - mean(product of the maps). The local moments come from
globally centred channels, as in the JAX package (E[x^2] - E[x]^2 on raw
Lab magnitudes loses ~3 digits in f32).

Input: channel-last ``(B, H, W, 3)`` RGB in [0, 1].
"""

import torch

from color_transfer_tpu_torch.core.blur import gaussian_blur
from color_transfer_tpu_torch.core.colorspace import rgb_to_lab
from color_transfer_tpu_torch.core.resize import resize_bilinear

_INTENT_WEIGHTS = {
    "perceptual": (0.002, 10.0, 10.0, 0.002, 0.002, 10.0, 10.0),
    "hue-preserving": (0.002, 10.0, 10.0, 0.002, 0.02, 10.0, 10.0),
    "chromatic": (0.002, 10.0, 10.0, 0.02, 0.02, 10.0, 10.0),
}


def icid(img1, img2, intent="perceptual", omit_maps67=False, downsampling=True,
         alpha=3):
    if intent not in _INTENT_WEIGHTS:
        raise ValueError(
            "Intent should be either 'perceptual', 'hue-preserving', or 'chromatic'"
        )
    w = _INTENT_WEIGHTS[intent]
    if downsampling:
        h, wd = img1.shape[-3], img1.shape[-2]
        f = max(1, round(min(h, wd) / 256))
        if f > 1:  # torch interpolate with scale_factor=1/f: floor(dim / f)
            out_hw = (h // f, wd // f)
            img1 = torch.movedim(resize_bilinear(torch.movedim(img1, -1, 1), out_hw), 1, -1)
            img2 = torch.movedim(resize_bilinear(torch.movedim(img2, -1, 1), out_hw), 1, -1)

    l1, a1, b1 = rgb_to_lab(img1).unbind(-1)
    l2, a2, b2 = rgb_to_lab(img2).unbind(-1)
    c1 = torch.sqrt(a1**2 + b1**2)
    c2 = torch.sqrt(a2**2 + b2**2)

    def blur(x):
        return gaussian_blur(x, 11, 2.0)

    def centred(x):
        return x - x.mean(dim=(-2, -1), keepdim=True)

    l1c, l2c, c1c, c2c = centred(l1), centred(l2), centred(c1), centred(c2)
    mu_l1, mu_c1, mu_l2, mu_c2 = blur(l1), blur(c1), blur(l2), blur(c2)
    mu_l1c, mu_c1c, mu_l2c, mu_c2c = blur(l1c), blur(c1c), blur(l2c), blur(c2c)

    def std(xc, muc):
        return torch.sqrt(torch.clamp_min(blur(xc**2) - muc**2, 0.0))

    s_l1, s_l2 = std(l1c, mu_l1c), std(l2c, mu_l2c)
    s_c1, s_c2 = std(c1c, mu_c1c), std(c2c, mu_c2c)

    dl_sq = (mu_l1 - mu_l2) ** 2
    dc_sq = (mu_c1 - mu_c2) ** 2
    hue = torch.clamp_min((a1 - a2) ** 2 + (b1 - b2) ** 2 - (c1 - c2) ** 2, 0.0)
    dh_sq = blur(torch.sqrt(hue)) ** 2
    s_l12 = blur(l1c * l2c) - mu_l1c * mu_l2c
    s_c12 = blur(c1c * c2c) - mu_c1c * mu_c2c

    maps = [
        1.0 / (w[0] * dl_sq + 1.0),
        (w[1] + 2.0 * s_l1 * s_l2) / (w[1] + s_l1**2 + s_l2**2),
        ((w[2] + torch.abs(s_l12)) / (w[2] + s_l1 * s_l2)) ** alpha,
        1.0 / (w[3] * dc_sq + 1.0),
        1.0 / (w[4] * dh_sq + 1.0),
        (w[5] + 2.0 * s_c1 * s_c2) / (w[5] + s_c1**2 + s_c2**2),
        (w[6] + torch.abs(s_c12)) / (w[6] + s_c1 * s_c2),
    ]
    if omit_maps67:  # the reference zeroes the exponents of maps 6-7
        maps = maps[:5]
    prod = maps[0]
    for m in maps[1:]:
        prod = prod * m
    return 1.0 - prod.mean()
