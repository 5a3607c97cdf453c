"""Image quality metrics — port of color_transfer_tpu/metrics: PSNR, SSIM
(piq) and the SSIM loss (kornia), iCID, FSIM. All take channel-last
``(B, H, W, 3)`` batches in [0, 1] and return a 0-d tensor."""

from color_transfer_tpu_torch.metrics.basic import psnr, ssim, ssim_loss
from color_transfer_tpu_torch.metrics.fsim import fsim
from color_transfer_tpu_torch.metrics.icid import icid

__all__ = ["psnr", "ssim", "ssim_loss", "icid", "fsim"]
