"""FSIM / FSIMc, the feature-similarity index — port of
color_transfer_tpu/metrics/fsim.py (Zhang et al., IEEE TIP 2011, as piq and
the MATLAB FSIM.m compute it, with Kovesi's phasecong2):

  1. scale to [0, 255], RGB -> YIQ, average-pool by f = round(min(H, W) / 256);
  2. phase congruency of both luminance images from a log-Gabor bank (4
     scales x 4 orientations) in the FFT domain (``torch.fft``), with the
     Rayleigh noise threshold from the median response at the smallest scale;
  3. Scharr gradient magnitude similarity;
  4. the FSIMc chromatic term on I/Q with lambda = 0.03 (the real part of
     the complex power for negative bases, as MATLAB takes it);
  5. score = sum(S_L * PCm) / sum(PCm).

The filter bank is built once per shape in numpy (the JAX package's
construction) and cached.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from color_transfer_tpu_torch.core.blur import filter3x3
from color_transfer_tpu_torch.core.colorspace import rgb_to_yiq
from color_transfer_tpu_torch.core.resize import avg_pool2d


@lru_cache(maxsize=16)
def _filter_bank(h, w, scales, orientations, min_length, mult, sigma_f, delta_theta):
    """Log-Gabor x angular-spread bank (numpy): filters[o, s, H, W] float32,
    following phasecong2.m's frequency-plane construction."""
    if w % 2 == 0:
        xr = np.arange(-w // 2, w // 2) / w
    else:
        xr = np.arange(-(w - 1) // 2, (w - 1) // 2 + 1) / w
    if h % 2 == 0:
        yr = np.arange(-h // 2, h // 2) / h
    else:
        yr = np.arange(-(h - 1) // 2, (h - 1) // 2 + 1) / h
    x, y = np.meshgrid(xr, yr)
    radius = np.fft.ifftshift(np.sqrt(x**2 + y**2))
    theta = np.fft.ifftshift(np.arctan2(-y, x))
    radius[0, 0] = 1.0
    lp = np.fft.ifftshift(1.0 / (1.0 + (np.sqrt(x**2 + y**2) / 0.45) ** 30))

    log_gabors = []
    for s in range(scales):
        fo = 1.0 / (min_length * mult**s)
        lg = np.exp(-(np.log(radius / fo) ** 2) / (2 * math.log(sigma_f) ** 2))
        lg *= lp
        lg[0, 0] = 0.0
        log_gabors.append(lg)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    theta_sigma = math.pi / orientations / delta_theta
    spreads = []
    for o in range(orientations):
        angl = o * math.pi / orientations
        ds = sin_t * math.cos(angl) - cos_t * math.sin(angl)
        dc = cos_t * math.cos(angl) + sin_t * math.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spreads.append(np.exp(-(dtheta**2) / (2 * theta_sigma**2)))

    filters = np.stack([np.stack([lg * sp for lg in log_gabors]) for sp in spreads])
    return filters.astype(np.float32)


def _median(x):
    """Median over the last axis; the mean of the two middle values for an
    even count (numpy's and jnp.median's convention)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def phase_congruency(x, scales=4, orientations=4, min_length=6, mult=2, sigma_f=0.55,
                     delta_theta=1.2, k=2.0, eps=1e-4):
    """Kovesi phasecong2 as FSIM uses it: PC map of (N, H, W) images."""
    n, h, w = x.shape
    filters = torch.from_numpy(
        _filter_bank(h, w, scales, orientations, min_length, mult, sigma_f, delta_theta)
    ).to(x.device)  # [O, S, H, W]

    imfft = torch.fft.fft2(x)[:, None, None]  # [N, 1, 1, H, W]
    eo = torch.fft.ifft2(imfft * filters)  # [N, O, S, H, W]
    an = torch.abs(eo)
    e, o_ = eo.real, eo.imag

    sum_an = an.sum(dim=2)  # [N, O, H, W]
    sum_e = e.sum(dim=2)
    sum_o = o_.sum(dim=2)
    x_energy = torch.sqrt(sum_e**2 + sum_o**2) + eps
    mean_e = (sum_e / x_energy)[:, :, None]
    mean_o = (sum_o / x_energy)[:, :, None]
    energy = (e * mean_e + o_ * mean_o - torch.abs(e * mean_o - o_ * mean_e)).sum(dim=2)

    # Rayleigh noise threshold (phasecong2.m's noise model).
    ifft_filters = torch.fft.ifft2(filters).real * math.sqrt(h * w)  # [O, S, H, W]
    em_n = (filters[:, 0] ** 2).sum(dim=(-2, -1))  # [O]
    median_e2n = _median((an[:, :, 0] ** 2).reshape(n, orientations, -1))  # [N, O]
    noise_power = (-median_e2n / math.log(0.5)) / em_n
    sum_est_sum_an2 = (ifft_filters**2).sum(dim=1).sum(dim=(-2, -1))  # [O]
    cross = torch.zeros(orientations, device=x.device)
    for si in range(scales - 1):
        for sj in range(si + 1, scales):
            cross = cross + (ifft_filters[:, si] * ifft_filters[:, sj]).sum(dim=(-2, -1))
    est_noise_energy2 = 2 * noise_power * sum_est_sum_an2 + 4 * noise_power * cross
    tau = torch.sqrt(est_noise_energy2 / 2.0)
    est_noise_energy = tau * math.sqrt(math.pi / 2.0)
    est_noise_sigma = torch.sqrt((2.0 - math.pi / 2.0) * tau**2)
    t = (est_noise_energy + k * est_noise_sigma) / 1.7  # empirical rescale

    energy = torch.clamp_min(energy - t[:, :, None, None], 0.0)
    return energy.sum(dim=1) / (sum_an.sum(dim=1) + eps)  # [N, H, W]


_SCHARR_X = [[v / 16.0 for v in row] for row in ((3, 0, -3), (10, 0, -10), (3, 0, -3))]
_SCHARR_Y = [list(col) for col in zip(*_SCHARR_X)]


def _scharr_grad(x):
    """Scharr gradient magnitude, zero 'same' padding (FSIM.m's dx, dy / 16)."""
    return torch.sqrt(filter3x3(x, _SCHARR_X) ** 2 + filter3x3(x, _SCHARR_Y) ** 2)


def _sim(a, b, t):
    return (2.0 * a * b + t) / (a**2 + b**2 + t)


def fsim(x, y, data_range=1.0, chromatic=True, valid_hw=None):
    """FSIM / FSIMc over channel-last (B, H, W, 3) batches in [0, data_range]:
    0..255 scaling, YIQ luminance, f-fold average pooling, T1 = 0.85, T2 =
    160, T3 = T4 = 200, lambda = 0.03.

    ``valid_hw``: the true (h, w) of a zero-padded batch (run/bucketing.py);
    the phase-congruency-weighted reduction then leaves out the padded
    region, whose step edge would otherwise dominate it. The global-FFT
    phase congruency inside the true region stays slightly perturbed."""
    x = x * (255.0 / data_range)
    y = y * (255.0 / data_range)
    if x.shape[-1] == 3:
        x, y = rgb_to_yiq(x), rgb_to_yiq(y)
    x = torch.movedim(x, -1, 1)
    y = torch.movedim(y, -1, 1)
    f = max(1, round(min(x.shape[-2], x.shape[-1]) / 256))
    if f > 1:
        x, y = avg_pool2d(x, f), avg_pool2d(y, f)
        if valid_hw is not None:
            valid_hw = (valid_hw[0] // f, valid_hw[1] // f)

    lum_x, lum_y = x[:, 0], y[:, 0]
    pc_x, pc_y = phase_congruency(lum_x), phase_congruency(lum_y)
    s_l = _sim(pc_x, pc_y, 0.85) * _sim(_scharr_grad(lum_x), _scharr_grad(lum_y), 160.0)
    if chromatic:
        lmbda = 0.03
        s_iq = _sim(x[:, 1], y[:, 1], 200.0) * _sim(x[:, 2], y[:, 2], 200.0)
        # MATLAB: real((S_I * S_Q)^lambda); a negative base's principal power
        # has real part |b|^lambda cos(pi lambda).
        mag = torch.abs(s_iq) ** lmbda
        s_l = s_l * torch.where(s_iq >= 0, mag, mag * math.cos(math.pi * lmbda))
    pc_max = torch.maximum(pc_x, pc_y)
    if valid_hw is not None:
        rows = torch.arange(pc_max.shape[-2], device=pc_max.device)[:, None] < valid_hw[0]
        cols = torch.arange(pc_max.shape[-1], device=pc_max.device)[None, :] < valid_hw[1]
        pc_max = pc_max * (rows & cols).to(pc_max.dtype)
    score = (s_l * pc_max).sum(dim=(-2, -1)) / pc_max.sum(dim=(-2, -1))
    return score.mean()
