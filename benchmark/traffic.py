"""The general traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that this module reads. Two kinds:

  * ``serve``: a clip of stereo frame pairs, each a smooth random scene
    (a ``scene_grid`` field of uniform colours, bilinearly upsampled) whose
    reference view is the target shifted by ``shift_px`` columns and
    colour-distorted by a gain and an offset; host float32 arrays, as a
    video job reads them, cycled in a closed loop.
  * ``fit``: ``pool_batches`` training batches of ``batch`` stereo crops,
    the gt view and its reference shifted by ``shift_px``, on the device.

Every draw comes from the run's seed; every seed gives the same sizes and
the same number of frames or rows, drawn anew."""

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.weights import derive

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name, directory=TRAFFIC_DIR):
    with open(Path(directory) / f"{name}.json") as f:
        return json.load(f)


def _scenes(n, height, width, grid, max_shift, g, device):
    low = torch.rand(n, 3, grid[0], grid[1], generator=g, device=device)
    scene = F.interpolate(low, size=(height, width + max_shift), mode="bilinear",
                          align_corners=False)
    return scene.permute(0, 2, 3, 1)


def stereo_pairs(n, height, width, mix, seed, device):
    """(target, reference) (n, H, W, 3) in [0, 1] on ``device``."""
    g = torch.Generator(device=device).manual_seed(derive(seed, 2))
    rng = np.random.default_rng(derive(seed, 3))
    lo, hi = mix["shift_px"]
    scene = _scenes(n, height, width, mix["scene_grid"], hi, g, device)
    shifts = rng.integers(lo, hi + 1, size=n)
    gains = rng.uniform(*mix.get("gain", (1.0, 1.0)), size=n)
    offsets = rng.uniform(*mix.get("offset", (0.0, 0.0)), size=n)
    target = scene[:, :, :width].contiguous()
    reference = torch.stack([
        (scene[i, :, s:s + width] * float(a) + float(b)).clamp(0.0, 1.0)
        for i, (s, a, b) in enumerate(zip(shifts, gains, offsets))])
    return target, reference


def serve_clip(mix, seed, device):
    """The clip of a ``serve`` mix: (target, reference) host float32 numpy
    arrays of shape (clip_frames, H, W, 3)."""
    t, r = stereo_pairs(mix["clip_frames"], mix["height"], mix["width"], mix, seed, device)
    return t.cpu().numpy(), r.cpu().numpy()


def fit_pool(mix, seed, device):
    """The batches of a ``fit`` mix: a list of {'gt', 'reference'} (B, H, W,
    3) on ``device``, every row distinct."""
    n, b = mix["pool_batches"], mix["batch"]
    gt, ref = stereo_pairs(n * b, mix["height"], mix["width"], mix, seed, device)
    return [{"gt": gt[i * b:(i + 1) * b], "reference": ref[i * b:(i + 1) * b]}
            for i in range(n)]
