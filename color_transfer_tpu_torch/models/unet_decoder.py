"""UNet decoder + segmentation head (smp layout), port of
color_transfer_tpu/models/unet_decoder.py.

Features arrive deepest last; the deepest becomes the head and the rest are
skips. Each block: x2 nearest upsample -> concat skip -> (Conv3x3 + ReLU) x2.
Head: Conv3x3 to out_channels, no activation. Parameter names follow smp
(``blocks.N.conv1.0``, ``head.0``). NHWC in and out. ``dtype`` (None for
float32): the convs compute in it as flax's ``dtype=`` does
(models/layers.py::conv_in), and each skip is cast to it before the
concatenation, as in the JAX package.
"""

import torch
import torch.nn.functional as F
from torch import nn

from color_transfer_tpu_torch.models.layers import conv_in, reduced_dtype


def _conv_relu(cin, cout):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    def __init__(self, in_channels, skip_channels, out_channels, dtype=None):
        super().__init__()
        self.dtype = reduced_dtype(dtype)
        self.conv1 = _conv_relu(in_channels + skip_channels, out_channels)
        self.conv2 = _conv_relu(out_channels, out_channels)

    def forward(self, x, skip=None):  # NCHW
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            if self.dtype is not None:
                skip = skip.to(self.dtype)
            x = torch.cat([x.to(skip.dtype), skip], dim=1)
        if self.dtype is None:
            return self.conv2(self.conv1(x))
        x = F.relu(conv_in(self.conv1[0], x, self.dtype))
        return F.relu(conv_in(self.conv2[0], x, self.dtype))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels, decoder_channels=(256, 128, 64, 32), dtype=None):
        """encoder_channels: channels of each feature, shallowest first."""
        super().__init__()
        enc = list(encoder_channels)[::-1]  # deepest first
        in_ch = [enc[0], *decoder_channels[:-1]]
        skip_ch = [enc[i + 1] if i + 1 < len(enc) else 0
                   for i in range(len(decoder_channels))]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o, dtype)
            for i, s, o in zip(in_ch, skip_ch, decoder_channels)
        )

    def forward(self, *features):
        feats = [f.permute(0, 3, 1, 2) for f in features[::-1]]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x.permute(0, 2, 3, 1)


class SegmentationHead(nn.Sequential):
    def __init__(self, in_channels, out_channels=3, dtype=None):
        super().__init__(nn.Conv2d(in_channels, out_channels, 3, padding=1))
        self.dtype = dtype

    def forward(self, x):
        return conv_in(self[0], x.permute(0, 3, 1, 2), self.dtype).permute(0, 2, 3, 1)
