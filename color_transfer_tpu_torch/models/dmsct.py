"""DMSCT — Deep Multi-Scale Color Transfer, f32 inference and training.

Port of color_transfer_tpu/models/dmsct.py: a frozen GMFlow matcher gives
bidirectional flow and the forward occlusion; an EfficientNet-b2 / UNet
corrector consumes, per pyramid level, ``[feat_target,
flow_warp(feat_reference, flow / 2^idx), 1 - occ]`` and predicts a residual
added onto the target. Submodule names (``matcher``, ``encoder``,
``decoder``, ``head``) follow the reference Lightning module, so the
state_dict is the layout color_transfer_tpu's ``convert_dmsct`` reads.

Training (``forward(..., train=True)``): the frozen matcher runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``), the encoder on
batch statistics with drop-connect, and each level's warp is
``flow_warp_batched``, whose backward scatters the feature cotangent in
kernel B7 on the card.
"""

import torch
import torch.nn.functional as F
from torch import nn

from color_transfer_tpu_torch.core.resize import (
    derive_matcher_size,
    resize_nearest,
    upsample_flow_bilinear,
)
from color_transfer_tpu_torch.core.sampling import flow_warp_batched
from color_transfer_tpu_torch.models.efficientnet import (
    EfficientNetEncoder,
    encoder_out_channels,
)
from color_transfer_tpu_torch.models.gmflow import GMFlow
from color_transfer_tpu_torch.models.unet_decoder import SegmentationHead, UnetDecoder
from color_transfer_tpu_torch.metrics.basic import ssim_loss


class DMSCT(nn.Module):
    def __init__(self, encoder_name="efficientnet-b2", encoder_depth=4,
                 decoder_channels=(256, 128, 64, 32), matcher_num_reg_refine=6,
                 matcher_num_layers=6):
        super().__init__()
        self.encoder_depth = encoder_depth
        self.matcher = GMFlow(num_transformer_layers=matcher_num_layers,
                              num_reg_refine=matcher_num_reg_refine)
        self.encoder = EfficientNetEncoder(encoder_name, encoder_depth)
        # Each level concatenates target, warped reference and 1 - occ.
        level_ch = [2 * c + 1 for c in encoder_out_channels(encoder_name, encoder_depth)]
        self.decoder = UnetDecoder(level_ch, tuple(decoder_channels))
        self.head = SegmentationHead(decoder_channels[-1], 3)

    def forward(self, target, reference, train=False, generator=None):
        """target/reference: (B, H, W, 3) in [0, 1]. Returns the corrected
        target clipped to [0, 1]. ``train``: the encoder's batch statistics
        and drop-connect (masks from ``generator``)."""
        _, height, width, _ = target.shape
        matcher_size = derive_matcher_size(height, width)
        with torch.no_grad():
            matcher_out = self.matcher(target * 255.0, reference * 255.0,
                                       inference_size=matcher_size)
        flow = matcher_out["flow"]
        fwd_occ = matcher_out["fwd_occ"]

        # Edge-pad to a multiple of 2^depth for the encoder.
        factor = 2**self.encoder_depth
        pad_h, pad_w = (-height) % factor, (-width) % factor

        def pad(x):
            if pad_h == 0 and pad_w == 0:
                return x
            return F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                         mode="replicate").permute(0, 2, 3, 1)

        flow = pad(flow)
        not_occ = pad(1.0 - fwd_occ)
        features_target = self.encoder(pad(target), train, generator)
        features_reference = self.encoder(pad(reference), train, generator)

        features = []
        for idx, (feat_t, feat_r) in enumerate(zip(features_target,
                                                   features_reference)):
            flow_idx = upsample_flow_bilinear(flow, 2.0**-idx) if idx else flow
            warped = flow_warp_batched(feat_r, flow_idx)
            occ_idx = not_occ
            if idx:
                occ_idx = torch.movedim(
                    resize_nearest(torch.movedim(not_occ, -1, 1),
                                   flow_idx.shape[1:3]), 1, -1,
                )
            features.append(torch.cat([feat_t, warped, occ_idx], dim=-1))

        if train:
            # With TF32 off, cuDNN's choice for the decoder's first 3x3 conv
            # at the training shape (batch 12, 256x480) is an FFT: decoder
            # and head take 102.60 ms forward with cuDNN against 24.58 ms
            # through ATen's im2col + GEMM. Their backward keeps cuDNN
            # (run/modules.py): 31.81 ms against ATen's 66.47 (chip_smoke.py
            # phase 7; NVIDIA H100 80GB HBM3, 700 W). Serving keeps cuDNN:
            # the 1080p decoder takes 20 ms with it (phase 4). (cuDNN's TF32
            # flag set by the context has no effect while it is off.)
            with torch.backends.cudnn.flags(enabled=False):
                residual = self.head(self.decoder(*features))
        else:
            residual = self.head(self.decoder(*features))
        corrected = target + residual[:, :height, :width, :]
        return corrected.clamp(0.0, 1.0)


def compute_losses(result, gt):
    """MSE + 0.1 * SSIM loss (reference methods/dmsct.py:121-122)."""
    loss_mse = ((result - gt) ** 2).mean()
    loss_ssim = 0.1 * ssim_loss(result, gt, window_size=11)
    return loss_mse + loss_ssim, {"MSE Loss": loss_mse, "SSIM Loss": loss_ssim}
