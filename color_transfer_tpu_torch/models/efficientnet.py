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

``dtype`` (the corrector's compute dtype, None for float32) computes the
convs as flax's ``dtype=`` does (models/layers.py::conv_in); BatchNorm's
statistics and normalisation are f32 and its output is in the dtype, the
squeeze-excite mean is taken in f32 and then cast, and the drop-connect
mask is cast to the activations' dtype, as in the JAX package.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from color_transfer_tpu_torch.models.layers import REDUCED, conv_in, reduced_dtype, widen
from color_transfer_tpu_torch.parallel.data_parallel import batch_moments, current_shard

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
    ``num_batches_tracked`` stays 0, as flax keeps no such count.

    In a data-parallel train step of more than one rank
    (parallel/data_parallel.py) the batch is the global one: its mean and
    biased variance combine every rank's (``batch_moments``), as the JAX
    package's sharded step computes them over the global array."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x, train=False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        shard = current_shard()
        if shard is not None and shard.world > 1:
            mean, var = batch_moments(x, (0, 2, 3))
            scale = self.weight * torch.rsqrt(var + self.eps)
            out = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
            mean, var = mean.detach(), var.detach()
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return out


def drop_connect(x, rate, generator=None):
    """Stochastic depth: keep each sample's residual branch with probability
    1 - rate and scale the kept ones by 1 / (1 - rate); one draw per sample
    from ``generator`` (on x's device). In a data-parallel train step the
    draws cover the global batch and this rank keeps its rows', so every
    world size draws the same masks."""
    keep = 1.0 - rate
    shard = current_shard()
    start, total = (shard.start, shard.total) if shard is not None else (0, x.shape[0])
    draw = torch.rand(total, 1, 1, 1, generator=generator, device=x.device)
    draw = draw[start:start + x.shape[0]]
    return x * (draw < keep).to(x.dtype) / keep


def _sigmoid(x):
    """The logistic; in a reduced dtype op by op, 1 / (1 + exp(-x)) rounded
    after each op, as jax.nn.sigmoid lowers on a bf16 array."""
    return 1 / (1 + torch.exp(-x)) if x.dtype in REDUCED else torch.sigmoid(x)


def _silu(x):
    """SiLU; in a reduced dtype x * sigmoid(x), the sigmoid rounded first
    (jax.nn.silu on a bf16 array)."""
    return x * _sigmoid(x) if x.dtype in REDUCED else F.silu(x)


def _bn(bn, x, train):
    """BatchNorm in f32 (statistics, running statistics, normalisation),
    the output in x's dtype (flax's BatchNorm with ``dtype=``)."""
    return bn(x.float(), train).to(x.dtype) if x.dtype in REDUCED else bn(x, train)


class MBConv(nn.Module):
    """Inverted bottleneck: expand 1x1, depthwise kxk, squeeze-excite on the
    block's input filter count, project 1x1, identity skip. NCHW."""

    def __init__(self, in_filters, out_filters, kernel, stride, expand,
                 se_ratio=0.25, dtype=None):
        super().__init__()
        self.dtype = reduced_dtype(dtype)
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
        dt = self.dtype
        inp = x
        if hasattr(self, "_expand_conv"):
            x = _silu(_bn(self._bn0, conv_in(self._expand_conv, x, dt), train))
        x = _silu(_bn(self._bn1, conv_in(self._depthwise_conv, x, dt), train))
        se = widen(x).mean(dim=(2, 3), keepdim=True).to(x.dtype)  # the mean in f32
        se = _sigmoid(conv_in(self._se_expand, _silu(conv_in(self._se_reduce, se, dt)), dt))
        x = _bn(self._bn2, conv_in(self._project_conv, x * se, dt), train)
        if self.skip:
            if train and drop_rate > 0:
                x = drop_connect(x, drop_rate, generator)
            x = x + inp
        return x


class EfficientNetEncoder(nn.Module):
    """NHWC image -> list of NHWC features [input, f2, f4, ...] (depth + 1
    entries). Only the blocks that feed the deepest requested tap exist."""

    def __init__(self, name_variant="efficientnet-b2", depth=4, drop_connect_rate=0.2,
                 dtype=None):
        super().__init__()
        self.dtype = reduced_dtype(dtype)
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
                                     s if r == 0 else 1, e, dtype=dtype))
                in_filters = out_filters
            if stage_idx in _TAPS and _TAPS[stage_idx] <= depth:
                self.tap_after[len(blocks) - 1] = _TAPS[stage_idx]
                produced += 1
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x, train=False, generator=None):
        """``train``: batch statistics (updating the running ones) and
        drop-connect, whose masks come from ``generator``."""
        features = [x]
        y = _silu(_bn(self._bn0, conv_in(self._conv_stem, x.permute(0, 3, 1, 2), self.dtype),
                      train))
        if self.depth >= 1:
            features.append(y.permute(0, 2, 3, 1))
        for i, block in enumerate(self._blocks):
            rate = self.drop_connect_rate * i / self.total_blocks
            y = block(y, train, rate, generator)
            if i in self.tap_after:
                features.append(y.permute(0, 2, 3, 1))
        return features
