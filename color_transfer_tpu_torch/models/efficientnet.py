"""EfficientNet encoder (b2 by default) in PyTorch, eval and train mode.

Port of color_transfer_tpu/models/efficientnet.py: the smp-style feature
pyramid [input, f2, f4, f8, f16, ...] up to ``depth`` reductions, where the
reduction-2 feature is the stem output. Parameter names follow
efficientnet-pytorch (``_conv_stem``, ``_bn0``, ``_blocks.N._expand_conv``
...), the layout color_transfer_tpu's ``convert_efficientnet`` reads.

BatchNorm uses eps 1e-3 (torch's default is 1e-5). In eval mode it runs
from its running statistics; in train mode (``forward(x, train=True)``) it
normalises with the batch statistics and updates the running ones as flax
does (``_BN``). Train mode also applies drop-connect (stochastic depth) on
the skip blocks, rate ``drop_connect_rate * block / total_blocks`` as in
the JAX package, one Bernoulli draw per sample from the generator passed
in. Padding is symmetric (k // 2), as in the JAX package.
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


class _BN(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)``. The state_dict
    keys are BatchNorm2d's. In train mode the output is normalised with the
    batch's biased variance (as torch does), and the running statistics
    move by 0.01 towards the batch mean and the *biased* variance, as flax
    moves them (flax takes E[x^2] - E[x]^2, the same up to rounding);
    ``nn.BatchNorm2d`` would move them towards the unbiased variance.
    ``num_batches_tracked`` stays 0, as flax keeps no such count."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x, train=False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return out


def drop_connect(x, rate, generator=None):
    """Stochastic depth: keep each sample's residual branch with probability
    1 - rate and scale the kept ones by 1 / (1 - rate); one draw per sample
    from ``generator`` (on x's device)."""
    keep = 1.0 - rate
    draw = torch.rand(x.shape[0], 1, 1, 1, generator=generator, device=x.device)
    return x * (draw < keep).to(x.dtype) / keep


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
            self._bn0 = _BN(filters)
        self._depthwise_conv = nn.Conv2d(
            filters, filters, kernel, stride, kernel // 2, groups=filters,
            bias=False,
        )
        self._bn1 = _BN(filters)
        se_filters = max(1, int(in_filters * se_ratio))
        self._se_reduce = nn.Conv2d(filters, se_filters, 1)
        self._se_expand = nn.Conv2d(se_filters, filters, 1)
        self._project_conv = nn.Conv2d(filters, out_filters, 1, bias=False)
        self._bn2 = _BN(out_filters)

    def forward(self, x, train=False, drop_rate=0.0, generator=None):
        inp = x
        if hasattr(self, "_expand_conv"):
            x = F.silu(self._bn0(self._expand_conv(x), train))
        x = F.silu(self._bn1(self._depthwise_conv(x), train))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(se))))
        x = self._bn2(self._project_conv(x * se), train)
        if self.skip:
            if train and drop_rate > 0:
                x = drop_connect(x, drop_rate, generator)
            x = x + inp
        return x


class EfficientNetEncoder(nn.Module):
    """NHWC image -> list of NHWC features [input, f2, f4, ...] (depth + 1
    entries). Only the blocks that feed the deepest requested tap exist."""

    def __init__(self, name_variant="efficientnet-b2", depth=4, drop_connect_rate=0.2):
        super().__init__()
        width, depth_c = _COEFFS[name_variant]
        self.depth = depth
        self.drop_connect_rate = drop_connect_rate
        # Drop-connect rates scale with the block's index over ALL the
        # variant's blocks, built or not (the JAX package's total_blocks).
        self.total_blocks = sum(round_repeats(s[4], depth_c) for s in _B0_STAGES)
        stem = round_filters(32, width)
        self._conv_stem = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
        self._bn0 = _BN(stem)
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

    def forward(self, x, train=False, generator=None):
        """``train``: batch statistics (updating the running ones) and
        drop-connect, whose masks come from ``generator``."""
        features = [x]
        y = F.silu(self._bn0(self._conv_stem(x.permute(0, 3, 1, 2)), train))
        if self.depth >= 1:
            features.append(y.permute(0, 2, 3, 1))
        for i, block in enumerate(self._blocks):
            rate = self.drop_connect_rate * i / self.total_blocks
            y = block(y, train, rate, generator)
            if i in self.tap_after:
                features.append(y.permute(0, 2, 3, 1))
        return features
