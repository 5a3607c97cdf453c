"""DMSCT in plain float32 torch: the frozen GMFlow matcher, then an
EfficientNet encoder (b2, depth 4) on both views, the reference features
warped by the flow at each level with 1 - occlusion beside them, a UNet
decoder (256, 128, 64, 32) and a 3x3 head whose residual is added to the
target and clipped. Training mode: the encoder's BatchNorm on the batch's
statistics (moving the running ones by flax's rule, momentum 0.99 on the
biased variance) and drop-connect drawn from a generator on the device.
The loss is MSE + 0.1 SSIM loss. Parameter names follow the reference
Lightning module (``matcher``, ``encoder``, ``decoder``, ``head``)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.gmflow import GMFlow
from benchmark.reference.ops import (
    derive_matcher_size,
    flow_warp,
    resize_nearest,
    ssim_loss,
    upsample_flow_bilinear,
)

# (kernel, stride, expand, base filters, base repeats) of EfficientNet-b0's
# stages; b2 scales width by 1.1 and depth by 1.2.
B0_STAGES = ((3, 1, 1, 16, 1), (3, 2, 6, 24, 2), (5, 2, 6, 40, 2), (3, 2, 6, 80, 3),
             (5, 1, 6, 112, 3), (5, 2, 6, 192, 4), (3, 1, 6, 320, 1))
COEFFS = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b1": (1.0, 1.1),
          "efficientnet-b2": (1.1, 1.2), "efficientnet-b3": (1.2, 1.4)}
TAPS = {1: 2, 2: 3, 4: 4, 6: 5}  # stage -> the pyramid index tapped after it


def round_filters(filters, width, divisor=8):
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * filters else new)


def encoder_channels(name, depth):
    """(3, stem, f4, f8, f16, ...) up to ``depth`` reductions."""
    width, _ = COEFFS[name]
    out = [round_filters(s[3], width) for s in B0_STAGES]
    return (3, round_filters(32, width), out[1], out[2], out[4], out[6])[:depth + 1]


class BN(nn.BatchNorm2d):
    """BatchNorm, eps 1e-3; train mode normalises by the batch's biased
    variance and moves the running statistics 0.01 towards the batch mean
    and biased variance."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-3, momentum=0.01)

    def forward(self, x, train=False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        out = ((x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
               * self.weight[:, None, None] + self.bias[:, None, None])
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
        return out


class MBConv(nn.Module):
    """Expand 1x1, depthwise kxk, squeeze-excite, project 1x1, identity skip
    with drop-connect in training. NCHW."""

    def __init__(self, cin, cout, kernel, stride, expand, se_ratio=0.25):
        super().__init__()
        filters = cin * expand
        self.skip = stride == 1 and cin == cout
        if expand != 1:
            self._expand_conv = nn.Conv2d(cin, filters, 1, bias=False)
            self._bn0 = BN(filters)
        self._depthwise_conv = nn.Conv2d(filters, filters, kernel, stride, kernel // 2,
                                         groups=filters, bias=False)
        self._bn1 = BN(filters)
        se = max(1, int(cin * se_ratio))
        self._se_reduce = nn.Conv2d(filters, se, 1)
        self._se_expand = nn.Conv2d(se, filters, 1)
        self._project_conv = nn.Conv2d(filters, cout, 1, bias=False)
        self._bn2 = BN(cout)

    def forward(self, x, train, rate, generator):
        inp = x
        if hasattr(self, "_expand_conv"):
            x = F.silu(self._bn0(self._expand_conv(x), train))
        x = F.silu(self._bn1(self._depthwise_conv(x), train))
        se = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(x.mean(dim=(2, 3),
                                                                         keepdim=True)))))
        x = self._bn2(self._project_conv(x * se), train)
        if not self.skip:
            return x
        if train and rate > 0:
            keep = 1.0 - rate
            draw = torch.rand(x.shape[0], 1, 1, 1, generator=generator, device=x.device)
            x = x * (draw < keep).to(x.dtype) / keep
        return x + inp


class EfficientNetEncoder(nn.Module):
    """NHWC image -> [input, f2, f4, ...] (depth + 1 NHWC features); only the
    blocks that feed the deepest tap exist. Drop-connect's rate grows with a
    block's index over all the variant's blocks."""

    def __init__(self, name="efficientnet-b2", depth=4, drop_connect_rate=0.2):
        super().__init__()
        width, depth_c = COEFFS[name]
        self.depth, self.drop_connect_rate = depth, drop_connect_rate
        self.total_blocks = sum(int(math.ceil(depth_c * s[4])) for s in B0_STAGES)
        stem = round_filters(32, width)
        self._conv_stem = nn.Conv2d(3, stem, 3, 2, 1, bias=False)
        self._bn0 = BN(stem)
        blocks, self.tap_after, produced, cin = [], {}, 2, stem
        for idx, (k, s, e, base, repeats) in enumerate(B0_STAGES):
            if produced >= depth + 1:
                break
            cout = round_filters(base, width)
            for r in range(int(math.ceil(depth_c * repeats))):
                blocks.append(MBConv(cin, cout, k, s if r == 0 else 1, e))
                cin = cout
            if idx in TAPS and TAPS[idx] <= depth:
                self.tap_after[len(blocks) - 1] = TAPS[idx]
                produced += 1
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x, train=False, generator=None):
        features = [x]
        y = F.silu(self._bn0(self._conv_stem(x.permute(0, 3, 1, 2)), train))
        features.append(y.permute(0, 2, 3, 1))
        for i, block in enumerate(self._blocks):
            y = block(y, train, self.drop_connect_rate * i / self.total_blocks, generator)
            if i in self.tap_after:
                features.append(y.permute(0, 2, 3, 1))
        return features


def _conv_relu(cin, cout):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    def __init__(self, cin, skip, cout):
        super().__init__()
        self.conv1 = _conv_relu(cin + skip, cout)
        self.conv2 = _conv_relu(cout, cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, enc_channels, dec_channels):
        super().__init__()
        enc = list(enc_channels)[::-1]
        cin = [enc[0], *dec_channels[:-1]]
        skip = [enc[i + 1] if i + 1 < len(enc) else 0 for i in range(len(dec_channels))]
        self.blocks = nn.ModuleList(DecoderBlock(i, s, o)
                                    for i, s, o in zip(cin, skip, dec_channels))

    def forward(self, *features):
        feats = [f.permute(0, 3, 1, 2) for f in features[::-1]]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x.permute(0, 2, 3, 1)


class Head(nn.Sequential):
    def __init__(self, cin, cout=3):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x):
        return self[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DMSCT(nn.Module):
    def __init__(self, encoder_name="efficientnet-b2", encoder_depth=4,
                 decoder_channels=(256, 128, 64, 32), matcher_num_layers=6,
                 matcher_num_reg_refine=6):
        super().__init__()
        self.encoder_depth = encoder_depth
        self.matcher = GMFlow(matcher_num_layers, matcher_num_reg_refine)
        self.encoder = EfficientNetEncoder(encoder_name, encoder_depth)
        level = [2 * c + 1 for c in encoder_channels(encoder_name, encoder_depth)]
        self.decoder = UnetDecoder(level, tuple(decoder_channels))
        self.head = Head(decoder_channels[-1])

    def forward(self, target, reference, train=False, generator=None):
        """target/reference (B, H, W, 3) in [0, 1] -> (corrected, the
        matcher's outputs)."""
        _, h, w, _ = target.shape
        with torch.no_grad():
            match = self.matcher(target * 255.0, reference * 255.0, derive_matcher_size(h, w))
        return self.correct(target, reference, match["flow"], match["fwd_occ"], train,
                            generator), match

    def correct(self, target, reference, flow, fwd_occ, train=False, generator=None):
        _, h, w, _ = target.shape
        factor = 2 ** self.encoder_depth
        ph, pw = (-h) % factor, (-w) % factor

        def pad(x):
            if ph == 0 and pw == 0:
                return x
            return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)

        flow, not_occ = pad(flow), pad(1.0 - fwd_occ)
        feats_t = self.encoder(pad(target), train, generator)
        feats_r = self.encoder(pad(reference), train, generator)
        levels = []
        for idx, (ft, fr) in enumerate(zip(feats_t, feats_r)):
            flow_idx = upsample_flow_bilinear(flow, 2.0 ** -idx) if idx else flow
            occ = not_occ
            if idx:
                occ = torch.movedim(resize_nearest(torch.movedim(not_occ, -1, 1),
                                                   flow_idx.shape[1:3]), 1, -1)
            levels.append(torch.cat([ft, flow_warp(fr, flow_idx), occ], dim=-1))
        residual = self.head(self.decoder(*levels))
        return (target + residual[:, :h, :w, :]).clamp(0.0, 1.0)


def loss(result, gt):
    """MSE + 0.1 * SSIM loss."""
    return ((result - gt) ** 2).mean() + 0.1 * ssim_loss(result, gt)


# The convolutions on cuDNN, as in serving (the GRU's two slow shapes go to
# ATen inside the matcher).
CUDNN = True


def build(config):
    return DMSCT(**config["sizes"])


def serve(model, target, reference):
    """-> (corrected frame, the matcher's outputs)."""
    return model(target, reference)


# The serving outputs the output check compares beside the corrected frame,
# where the configuration captures them: {number: (output, rule of
# benchmark/serve.py's RULES)}. The flow's widest gap in pixels, and the
# share of forward-occlusion pixels that differ.
SERVE_OUTPUTS = {"flow_max_px": ("flow", "max_abs"), "occ_mismatch": ("fwd_occ", "differ_share")}


def trainable(name):
    """The corrector trains; the matcher is frozen."""
    return not name.startswith("matcher.")


def train_loss(model, batch, generator):
    result, _ = model(batch["target"], batch["reference"], train=True, generator=generator)
    return loss(result, batch["gt"])
