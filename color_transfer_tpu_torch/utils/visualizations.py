"""Qualitative-inspection panels — port of
color_transfer_tpu/utils/visualizations.py (the reference's
utils/visualizations.py).

Channel-last (B, H, W, 3) float images in [0, 1]:
  * chess_mix — a 25-pixel checkerboard of gt and result;
  * rgbmse / labmse / abmse — min-max-scaled error heat in the red channel;
  * rgbssim — the SSIM map's error in the red channel.
"""

import torch

from color_transfer_tpu_torch.core.colorspace import rgb_to_lab
from color_transfer_tpu_torch.metrics.basic import _ssim_map


def chess_mix(x, y, size=25):
    """Checkerboard of two aligned images: even cells from x, odd from y."""
    h, w = x.shape[-3], x.shape[-2]
    iy = (torch.arange(h, device=x.device) // size)[:, None]
    ix = (torch.arange(w, device=x.device) // size)[None, :]
    take_x = ((iy + ix) % 2 == 0)[..., None]
    return torch.where(take_x, x, y)


def minmaxscale(x, axes=(-1, -2)):
    mn = x.amin(dim=axes, keepdim=True)
    mx = x.amax(dim=axes, keepdim=True)
    return (x - mn) / (mx - mn + 1e-12)


def _red_channel_error(x, m):
    error = torch.zeros_like(x)
    error[..., 0] = minmaxscale(m)
    return error


def rgbmse(x, y):
    return _red_channel_error(x, ((x - y) ** 2).mean(dim=-1))


def labmse(x, y):
    # The reference's quirk kept: Lab of the squared difference.
    return _red_channel_error(x, rgb_to_lab((x - y) ** 2).mean(dim=-1))


def abmse(x, y):
    return _red_channel_error(x, rgb_to_lab((x - y) ** 2)[..., 1:].mean(dim=-1))


def rgbssim(x, y):
    smap = _ssim_map(torch.movedim(x, -1, 1), torch.movedim(y, -1, 1), kernel_size=11,
                     kernel_sigma=1.5, data_range=1.0, k1=0.01, k2=0.03,
                     padding="same")  # (B, C, H, W)
    return _red_channel_error(x, 0.5 - smap.mean(dim=1) / 2.0)
