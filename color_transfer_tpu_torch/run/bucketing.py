"""Bucketed evaluation — port of color_transfer_tpu/run/bucketing.py.

Each item is zero-padded up to a ladder of shapes (multiples of
``multiple``) and scored on its true region. The JAX package buckets to
compile once per bucket rather than once per shape; torch compiles
nothing, but the masked metrics are what a user of ``--eval_buckets`` gets,
so the port keeps them:

  * images are zero-padded (SAME-conv zero padding, so conv features away
    from the true border are unchanged);
  * DCMCS3DI masks attention columns at or beyond the true width
    (``valid_w``), so padded pixels receive no attention;
  * PSNR is exact over the true region; SSIM keeps the windows that lie
    wholly inside it (exact map values; the downsampling factor comes from
    the bucket's shape); iCID and FSIM score the zero-masked pair with
    their reductions restricted to the true region (a blur-band
    approximation at its border).

Outputs inside the true region differ from a native-shape evaluation only
within a conv receptive field of the padded border.
"""

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch import metrics as M
from color_transfer_tpu_torch.core.resize import avg_pool2d
from color_transfer_tpu_torch.metrics.basic import _ssim_map


def snap_shape(h, w, multiple=64):
    """The smallest (H, W) >= (h, w) with both multiples of ``multiple``."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def pad_batch(batch, bucket_hw, keys=("gt", "target", "reference")):
    """Zero-pad the (B, H, W, C) images of ``batch`` up to ``bucket_hw``.
    Returns (padded batch, true (h, w))."""
    bh, bw = bucket_hw
    out = dict(batch)
    true_hw = None
    for k in keys:
        if k in batch:
            h, w = batch[k].shape[1:3]
            true_hw = (h, w)
            out[k] = F.pad(batch[k], (0, 0, 0, bw - w, 0, bh - h))
    return out, true_hw


def _valid_mask(shape_hw, h_t, w_t, device, dtype=torch.float32):
    rows = torch.arange(shape_hw[0], device=device)[:, None] < h_t
    cols = torch.arange(shape_hw[1], device=device)[None, :] < w_t
    return (rows & cols).to(dtype)


def masked_psnr(x, y, h_t, w_t, data_range=1.0, eps=1e-10):
    """piq.psnr over the true region only (exact)."""
    mask = _valid_mask(x.shape[1:3], h_t, w_t, x.device, x.dtype)[None, ..., None]
    mse = (((x - y) * mask) ** 2).sum(dim=(1, 2, 3)) / (h_t * w_t * x.shape[-1])
    return (10.0 * torch.log10(data_range**2 / (mse + eps))).mean()


def masked_ssim(x, y, h_t, w_t, kernel_size=11, kernel_sigma=1.5, data_range=1.0):
    """piq.ssim over the valid-filter windows that lie wholly inside the
    true region: those windows give exactly the native map's values."""
    x = torch.movedim(x, -1, 1)
    y = torch.movedim(y, -1, 1)
    f = max(1, round(min(x.shape[-2], x.shape[-1]) / 256))
    if f > 1:
        x, y = avg_pool2d(x, f), avg_pool2d(y, f)
        h_t, w_t = h_t // f, w_t // f
    smap = _ssim_map(x, y, kernel_size, kernel_sigma, data_range, 0.01, 0.03, "valid")
    valid = _valid_mask(smap.shape[-2:], h_t - kernel_size + 1, w_t - kernel_size + 1,
                        smap.device, smap.dtype)
    count = (h_t - kernel_size + 1) * (w_t - kernel_size + 1)
    per_image = (smap * valid).sum(dim=(1, 2, 3)) / (smap.shape[1] * count)
    return per_image.mean()


def masked_quality_metrics(out, gt, h_t, w_t, prefix="", heavy=True):
    """The reference's four metrics at a bucket's shape, on the true
    (h_t, w_t) region: PSNR exact, SSIM exact on interior windows, iCID and
    FSIM on the zero-masked pair with their means over the true region."""
    mask = _valid_mask(out.shape[1:3], h_t, w_t, out.device, out.dtype)[None, ..., None]
    out_m, gt_m = out * mask, gt * mask
    vals = {
        f"{prefix}PSNR": masked_psnr(out, gt, h_t, w_t),
        f"{prefix}SSIM": masked_ssim(out, gt, h_t, w_t),
        f"{prefix}iCID": M.icid(out_m, gt_m, valid_hw=(h_t, w_t)),
    }
    if heavy:
        vals[f"{prefix}FSIM"] = M.fsim(out_m, gt_m, valid_hw=(h_t, w_t))
    return vals


class BucketedEvaluator:
    """Evaluate a module at bucket shapes: pad, run, score the true region.
    A module with ``supports_valid_w`` gets the true width (attention
    masking); another runs on the padded batch as it is."""

    def __init__(self, module, multiple=64):
        self.module = module
        self.multiple = multiple

    def forward(self, variables, batch):
        """(output at the bucket's shape clipped to [0, 1], padded batch)."""
        h, w = batch["gt"].shape[1:3]
        padded, _ = pad_batch(batch, snap_shape(h, w, self.multiple))
        if getattr(self.module, "supports_valid_w", False):
            out = self.module.eval_forward(variables, padded, valid_w=w)
        else:
            out = self.module.eval_forward(variables, padded)
        return out.clamp(0.0, 1.0), padded

    def metrics(self, out, padded_gt, true_hw, heavy=True):
        """The masked metrics of a bucket-shaped output on its true region."""
        with torch.no_grad():
            return masked_quality_metrics(out, padded_gt, *true_hw, heavy=heavy)

    def eval_batch(self, variables, batch, heavy=True):
        """(output cropped to the true shape, masked metrics)."""
        h, w = batch["gt"].shape[1:3]
        out, padded = self.forward(variables, batch)
        return out[:, :h, :w], self.metrics(out, padded["gt"], (h, w), heavy)
