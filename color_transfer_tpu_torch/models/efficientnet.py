"""EfficientNet encoder (b2 by default) in PyTorch, eval mode.

Port of color_transfer_tpu/models/efficientnet.py: the smp-style feature
pyramid [input, f2, f4, f8, f16, ...] up to ``depth`` reductions, where the
reduction-2 feature is the stem output. Parameter names follow
efficientnet-pytorch (``_conv_stem``, ``_bn0``, ``_blocks.N._expand_conv``
...), the layout color_transfer_tpu's ``convert_efficientnet`` reads.

BatchNorm uses eps 1e-3 (torch's default is 1e-5) and runs from its running
statistics; drop-connect is a training-only op and is not ported. Padding is
symmetric (k // 2), as in the JAX package.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# (kernel, stride, expand, base_out_filters, base_repeats) for b0 stages.
_B0_STAGES = [
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
]

_COEFFS = {  # width, depth
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
}

# Stages after which a pyramid feature is tapped -> its index in the pyramid.
_TAPS = {1: 2, 2: 3, 4: 4, 6: 5}


def round_filters(filters, width, divisor=8):
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats, depth):
    return int(math.ceil(depth * repeats))


def encoder_out_channels(name="efficientnet-b2", depth=4):
    """smp-compatible out_channels, e.g. b2/depth4 -> (3, 32, 24, 48, 120)."""
    width, _ = _COEFFS[name]
    stage_out = [round_filters(s[3], width) for s in _B0_STAGES]
    stem = round_filters(32, width)
    channels = (3, stem, stage_out[1], stage_out[2], stage_out[4], stage_out[6])
    return channels[: depth + 1]


def _bn(channels):
    return nn.BatchNorm2d(channels, eps=1e-3, momentum=0.01)


class MBConv(nn.Module):
    """Inverted bottleneck: expand 1x1, depthwise kxk, squeeze-excite on the
    block's input filter count, project 1x1, identity skip. NCHW."""

    def __init__(self, in_filters, out_filters, kernel, stride, expand,
                 se_ratio=0.25):
        super().__init__()
        filters = in_filters * expand
        self.skip = stride == 1 and in_filters == out_filters
        if expand != 1:
            self._expand_conv = nn.Conv2d(in_filters, filters, 1, bias=False)
            self._bn0 = _bn(filters)
        self._depthwise_conv = nn.Conv2d(
            filters, filters, kernel, stride, kernel // 2, groups=filters,
            bias=False,
        )
        self._bn1 = _bn(filters)
        se_filters = max(1, int(in_filters * se_ratio))
        self._se_reduce = nn.Conv2d(filters, se_filters, 1)
        self._se_expand = nn.Conv2d(se_filters, filters, 1)
        self._project_conv = nn.Conv2d(filters, out_filters, 1, bias=False)
        self._bn2 = _bn(out_filters)

    def forward(self, x):
        inp = x
        if hasattr(self, "_expand_conv"):
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(se))))
        x = self._bn2(self._project_conv(x * se))
        if self.skip:
            x = x + inp
        return x


class EfficientNetEncoder(nn.Module):
    """NHWC image -> list of NHWC features [input, f2, f4, ...] (depth + 1
    entries). Only the blocks that feed the deepest requested tap exist."""

    def __init__(self, name_variant="efficientnet-b2", depth=4):
        super().__init__()
        width, depth_c = _COEFFS[name_variant]
        self.depth = depth
        stem = round_filters(32, width)
        self._conv_stem = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
        self._bn0 = _bn(stem)
        blocks, self.tap_after = [], {}
        produced, in_filters = 2, stem  # input + the stem tap
        for stage_idx, (k, s, e, base_out, base_r) in enumerate(_B0_STAGES):
            if produced >= depth + 1:
                break
            out_filters = round_filters(base_out, width)
            for r in range(round_repeats(base_r, depth_c)):
                blocks.append(MBConv(in_filters, out_filters, k,
                                     s if r == 0 else 1, e))
                in_filters = out_filters
            if stage_idx in _TAPS and _TAPS[stage_idx] <= depth:
                self.tap_after[len(blocks) - 1] = _TAPS[stage_idx]
                produced += 1
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x):
        features = [x]
        y = F.silu(self._bn0(self._conv_stem(x.permute(0, 3, 1, 2))))
        if self.depth >= 1:
            features.append(y.permute(0, 2, 3, 1))
        for i, block in enumerate(self._blocks):
            y = block(y)
            if i in self.tap_after:
                features.append(y.permute(0, 2, 3, 1))
        return features
