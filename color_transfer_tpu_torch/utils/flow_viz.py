"""Optical-flow visualisation, the Middlebury colour wheel — port of
color_transfer_tpu/utils/flow_viz.py (the reference's utils/flow_viz.py;
Baker et al., "A Database and Evaluation Methodology for Optical Flow").
Host-side numpy: panels only, not a hot path; ``flow_batch_to_images``
takes a tensor on any device.
"""

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel():
    """55-colour wheel (RY=15, YG=6, GC=4, CB=11, BM=13, MR=6)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u, v):
    """Flow components (normalised to radius <= 1) -> (H, W, 3) uint8."""
    h, w = u.shape
    img = np.zeros((h, w, 3), dtype=np.uint8)
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255
        col1 = _WHEEL[k1, i] / 255
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[:, :, i] = np.floor(255 * col * (~nan_idx)).astype(np.uint8)
    return img


def flow_to_image(flow, rad_max=None):
    """(H, W, 2) flow -> (H, W, 3) uint8 visualisation."""
    u = np.array(flow[..., 0], dtype=np.float64, copy=True)
    v = np.array(flow[..., 1], dtype=np.float64, copy=True)
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    rad_max = rad_max if rad_max is not None else max(rad.max(), 1e-5)
    u = u / (rad_max + np.finfo(float).eps)
    v = v / (rad_max + np.finfo(float).eps)
    img = compute_color(u, v)
    img[unknown] = 0
    return img


def flow_batch_to_images(flows):
    """(B, H, W, 2) array or tensor -> (B, H, W, 3) uint8, each item
    normalised by its own largest radius (the reference's per-image
    normalisation)."""
    if hasattr(flows, "detach"):
        flows = flows.detach().cpu().numpy()
    return np.stack([flow_to_image(np.asarray(f)) for f in flows])
