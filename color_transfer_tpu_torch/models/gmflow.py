"""GMFlow / UniMatch optical-flow matcher (flow task, f32) in PyTorch.

Port of color_transfer_tpu/models/gmflow.py: 2 scales, 128 channels,
upsample x4, 6 transformer layers, 6 GRU refinements. Parameter names follow
the reference torch layout (unimatch), so color_transfer_tpu's
``tools/convert_gmflow.convert_state_dict`` maps this module's state_dict
onto the JAX tree one-to-one.

Conventions kept from the JAX package:
  * public tensors are channel-last (NHWC); convolutions run on permuted
    (channels-last) views;
  * bidirectional flow uses the batch-block layout [forward x B,
    backward x B], correct for every batch size;
  * the transformer runs window-major (tokens stay in (B*k*k, hs*ws, C)
    windows across layers);
  * LayerNorm eps 1e-6, exact-erf GELU, InstanceNorm eps 1e-5.
The GRU loop's correlation is ops/local_corr.py (the CUDA kernel on a
CUDA tensor). With ``fused_attention=True`` the transformer's eligible
layers run the fused ops of ops/win_attention.py (kernels B2b and B2c on a
CUDA tensor).
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from color_transfer_tpu_torch.core.resize import resize_bilinear
from color_transfer_tpu_torch.core.sampling import (
    coords_grid,
    flow_warp,
    forward_backward_consistency,
)
from color_transfer_tpu_torch.ops.local_corr import local_correlation_with_flow
from color_transfer_tpu_torch.ops.win_attention import (
    eligible,
    ffn_eligible,
    ffn_fused,
    window_attention_fused,
    window_sublayer_fused,
)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CNN encoder
# ---------------------------------------------------------------------------


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.norm1 = nn.InstanceNorm2d(planes, eps=1e-5)
        self.norm2 = nn.InstanceNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride),
                nn.InstanceNorm2d(planes, eps=1e-5),
            )

    def forward(self, x):  # NCHW
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _TridentConv(nn.Module):
    """One 3x3 weight applied at strides 1 and 2 (no bias)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x):
        return [F.conv2d(x, self.weight, stride=s, padding=1) for s in (1, 2)]


class CNNEncoder(nn.Module):
    """RAFT-style encoder emitting the 1/4 and 1/8 scales through the
    shared-weight trident conv. NHWC in, list of NHWC out (high to low
    resolution)."""

    def __init__(self, output_dim=128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.norm1 = nn.InstanceNorm2d(64, eps=1e-5)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64), ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128), ResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        self.trident_conv = _TridentConv(output_dim)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(_nchw(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        return [_nhwc(y) for y in self.trident_conv(x)]


# ---------------------------------------------------------------------------
# Position embedding and swin windows
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _sine_position(h, w, num_pos_feats=64, temperature=10000, scale=2 * math.pi):
    """DETR sine embedding on an all-ones mask, numpy, (H, W, 2*num)."""
    y_embed = np.cumsum(np.ones((h, w)), axis=0)
    x_embed = np.cumsum(np.ones((h, w)), axis=1)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=-1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=-1).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


def feature_add_position(feature0, feature1, attn_splits, channels):
    """Add the sine embedding per split window."""
    b, h, w, c = feature0.shape
    s = max(attn_splits, 1)
    pos = torch.from_numpy(_sine_position(h // s, w // s, channels // 2))
    pos = pos.to(feature0.device).repeat(s, s, 1)  # tiled on the device
    return feature0 + pos, feature1 + pos


def split_windows(x, k):
    """(B, H, W, C) -> (B*k*k, H/k, W/k, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x, k):
    bk, hs, ws, c = x.shape
    x = x.reshape(bk // (k * k), k, k, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hs, k * ws, c)


def shift_window_mask(h, w, k, device=None):
    """Additive (-100 / 0) shifted-window mask (k*k, hs*ws, hs*ws) float32:
    tokens of one window attend iff their (h-band, w-band) region labels
    agree in rolled coordinates. The labels come from numpy (h*w integers);
    the mask itself is built on ``device``."""
    hs, ws = h // k, w // k
    sh, sw = hs // 2, ws // 2
    img = np.zeros((1, h, w, 1), dtype=np.float32)
    cnt = 0
    for hsl in (slice(0, -hs), slice(-hs, -sh), slice(-sh, None)):
        for wsl in (slice(0, -ws), slice(-ws, -sw), slice(-sw, None)):
            img[:, hsl, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, k, hs, k, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    win = torch.from_numpy(win.reshape(k * k, hs * ws)).to(device)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


def window_attention(q, k, v, mask=None):
    """softmax(q k^T / sqrt(C) + mask) v over (N, L, C) window batches; the
    (k*k, L, L) mask repeats over the window batch (window w gets
    mask[w % k*k])."""
    c = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c)
    if mask is not None:
        n = mask.shape[0]
        scores = (scores.reshape(-1, n, *scores.shape[1:]) + mask).reshape(
            scores.shape
        )
    return torch.matmul(torch.softmax(scores, dim=-1), v)


# ---------------------------------------------------------------------------
# Feature transformer
# ---------------------------------------------------------------------------


class TransformerLayer(nn.Module):
    """Attention sublayer (+ FFN) on window-major tokens (N, L, C).

    ``fused_attention`` is the JAX package's knob (models/gmflow.py:339-460)
    with its routing: "auto" fuses when the tokens are bfloat16, so the
    port's float32 matcher stays unfused; True sends the layer through the
    fused ops of ops/win_attention.py where JAX's guards allow: the tokens
    are windowed (more than one split), c_in == d_model and the working set
    passes ``eligible`` / ``ffn_eligible``; then the attention sublayer is
    one ``window_sublayer_fused`` call (B2b; with no FFN it emits the whole
    layer) and the FFN one ``ffn_fused`` call (B2c). When only c_in !=
    d_model refuses the sublayer, the attention alone goes through
    ``window_attention_fused`` (B2a). False: unfused. The parameters are
    the same on every route."""

    def __init__(self, d_model=128, no_ffn=False, ffn_dim_expansion=4,
                 fused_attention="auto"):
        super().__init__()
        if fused_attention not in ("auto", True, False):
            raise ValueError(
                f"fused_attention must be 'auto', True or False, got "
                f"{fused_attention!r} (the port has no interpret mode: CPU "
                "tensors take the plain versions)"
            )
        self.fused_attention = fused_attention
        self.no_ffn = no_ffn
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        if not no_ffn:
            in_channels = 2 * d_model
            self.mlp = nn.Sequential(
                nn.Linear(in_channels, in_channels * ffn_dim_expansion, bias=False),
                nn.GELU(),
                nn.Linear(in_channels * ffn_dim_expansion, d_model, bias=False),
            )
            self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, source, target, mask=None, *, shift_windows=None,
                windowed=False):
        """``mask``: the (k*k, L, L) shift mask or None; ``shift_windows``:
        the same mask as its geometry (k, hs, ws), which the fused ops read;
        ``windowed``: the tokens are split into more than one window."""
        fused = self.fused_attention
        if fused == "auto":
            fused = source.dtype == torch.bfloat16
        fused = fused and windowed
        d = self.merge.weight.shape[0]
        tokens = (*source.shape[:-1], d)
        same_width = source.shape[-1] == d
        if fused and same_width and eligible(tokens, source.dtype):
            # The weights in JAX's input-major layout, [W_k | W_v] joined.
            message = window_sublayer_fused(
                source, target, self.q_proj.weight.t(),
                torch.cat([self.k_proj.weight, self.v_proj.weight]).t(),
                self.merge.weight.t(), self.norm1.weight, self.norm1.bias,
                shift_windows=shift_windows, add_residual=self.no_ffn,
            )
            if self.no_ffn:
                return message  # source + LN1(sublayer), the whole layer
        else:
            q = self.q_proj(source)
            k = self.k_proj(target)
            v = self.v_proj(target)
            if fused and eligible(q.shape, q.dtype):
                message = window_attention_fused(q, k, v, shift_windows=shift_windows)
            else:
                message = window_attention(q, k, v, mask)
            message = self.norm1(self.merge(message))
        if not self.no_ffn:
            w0, w2 = self.mlp[0].weight, self.mlp[2].weight
            if fused and same_width and ffn_eligible(tokens, source.dtype, w0.shape[0]):
                return ffn_fused(source, message, w0.t(), w2.t(), self.norm2.weight,
                                 self.norm2.bias, add_residual=True)
            message = self.mlp(torch.cat([source, message], dim=-1))
            message = self.norm2(message)
        return source + message


class TransformerBlock(nn.Module):
    """self-attn (no FFN) + cross-attn + FFN."""

    def __init__(self, d_model=128, ffn_dim_expansion=4, fused_attention="auto"):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion,
                                          fused_attention)
        self.cross_attn_ffn = TransformerLayer(d_model, False, ffn_dim_expansion,
                                               fused_attention)

    def forward(self, source, target, mask=None, *, shift_windows=None,
                windowed=False):
        route = {"shift_windows": shift_windows, "windowed": windowed}
        source = self.self_attn(source, source, mask, **route)
        return self.cross_attn_ffn(source, target, mask, **route)


def _swap_halves(x):
    half0, half1 = x.chunk(2, dim=0)
    return torch.cat([half1, half0], dim=0)


class FeatureTransformer(nn.Module):
    """TransformerBlocks over the [f0|f1] / [f1|f0] siamese batch, swin
    windows, run window-major: tokens stay in (2B*k*k, hs*ws, C) windows;
    odd (shifted) layers roll the image by half a window before and after.
    The cross-attention target is a batch-half swap of the source."""

    def __init__(self, num_layers=6, d_model=128, ffn_dim_expansion=4,
                 fused_attention="auto"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, fused_attention)
            for _ in range(num_layers)
        )

    def forward(self, feature0, feature1, attn_num_splits):
        """(B, H, W, C) x2 -> (B, H, W, C) x2."""
        b, h, w, c = feature0.shape
        k = attn_num_splits
        hs, ws = h // k, w // k

        def to_win(img):
            return split_windows(img, k).reshape(-1, hs * ws, c)

        def from_win(tokens):
            return merge_windows(tokens.reshape(-1, hs, ws, c), k)

        mask = None
        if k > 1:
            mask = shift_window_mask(h, w, k, feature0.device)
        src = to_win(torch.cat([feature0, feature1], dim=0))
        for i, layer in enumerate(self.layers):
            shifted = k > 1 and i % 2 == 1
            if shifted:
                src = to_win(torch.roll(from_win(src), (-(hs // 2), -(ws // 2)),
                                        dims=(1, 2)))
            src = layer(src, _swap_halves(src), mask if shifted else None,
                        shift_windows=(k, hs, ws) if shifted else None,
                        windowed=k > 1)
            if shifted:
                src = to_win(torch.roll(from_win(src), (hs // 2, ws // 2),
                                        dims=(1, 2)))
        f0, f1 = from_win(src).chunk(2, dim=0)
        return f0, f1


# ---------------------------------------------------------------------------
# Correlation / matching
# ---------------------------------------------------------------------------


def global_correlation_softmax(feature0, feature1, pred_bidir_flow=False):
    """All-pairs correlation -> softmax -> expected coords -> flow.
    Bidirectional output is block-concat [forward x B, backward x B].
    Returns (flow (B', H, W, 2), prob (B', HW, HW))."""
    b, h, w, c = feature0.shape
    f0 = feature0.reshape(b, h * w, c)
    f1 = feature1.reshape(b, h * w, c)
    correlation = torch.matmul(f0, f1.transpose(1, 2)) / math.sqrt(c)
    grid = coords_grid(h, w, device=feature0.device).reshape(h * w, 2)
    if pred_bidir_flow:
        correlation = torch.cat([correlation, correlation.transpose(1, 2)], dim=0)
        b = b * 2
    prob = torch.softmax(correlation, dim=-1)
    correspondence = torch.matmul(prob, grid)
    flow = correspondence.reshape(b, h, w, 2) - grid.reshape(1, h, w, 2)
    return flow, prob


def _window_offsets(radius, device=None):
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox, oy], dim=-1).reshape(-1, 2)  # (K2, 2) as (x, y)


def local_correlation_softmax(feature0, feature1, local_radius):
    """Windowed correlation softmax over the (2r+1)^2 integer offsets, zero
    padded; one offset at a time, so live memory stays O(B*H*W*C).
    Returns (flow (B, H, W, 2), prob (B, H, W, K2))."""
    b, h, w, c = feature0.shape
    r = local_radius
    coords = coords_grid(h, w, device=feature0.device)
    offsets = _window_offsets(r, feature0.device)
    padded1 = F.pad(feature1, (0, 0, r, r, r, r))
    corr, valid = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded1[:, r + dy : r + dy + h, r + dx : r + dx + w]
            corr.append((feature0 * shifted).sum(-1))
            x_pos = coords[..., 0] + dx
            y_pos = coords[..., 1] + dy
            valid.append((x_pos >= 0) & (x_pos < w) & (y_pos >= 0) & (y_pos < h))
    corr = torch.stack(corr, dim=-1) / math.sqrt(c)
    corr = torch.where(torch.stack(valid, dim=-1), corr, -1e9)
    prob = torch.softmax(corr, dim=-1)
    sample_coords = coords[:, :, None, :] + offsets  # (H, W, K2, 2)
    correspondence = torch.einsum("bhwk,hwkt->bhwt", prob, sample_coords)
    return correspondence - coords, prob


# ---------------------------------------------------------------------------
# Self-attention flow propagation
# ---------------------------------------------------------------------------


def _unfold_nhwc(x, kernel_size):
    """Zero-padded kernel_size^2 neighbourhoods: (B, H, W, C) ->
    (B, H, W, K2, C), window index row-major like F.unfold."""
    r = kernel_size // 2
    b, h, w, c = x.shape
    padded = F.pad(x, (0, 0, r, r, r, r))
    views = [padded[:, dy : dy + h, dx : dx + w]
             for dy in range(kernel_size) for dx in range(kernel_size)]
    return torch.stack(views, dim=3)


class SelfAttnPropagation(nn.Module):
    def __init__(self, in_channels=128):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0, flow, local_window_attn=False,
                local_window_radius=1):
        b, h, w, c = feature0.shape
        query = self.q_proj(feature0)
        if not local_window_attn:
            # Reference quirk kept for checkpoint parity: in the global path
            # the key is a projection of the already-projected query.
            key = self.k_proj(query)
            q = query.reshape(b, h * w, c)
            k = key.reshape(b, h * w, c)
            v = flow.reshape(b, h * w, flow.shape[-1])
            scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
            return out.reshape(b, h, w, flow.shape[-1])
        key = self.k_proj(feature0)
        ksz = 2 * local_window_radius + 1
        key_w = _unfold_nhwc(key, ksz)  # (B, H, W, K2, C)
        flow_w = _unfold_nhwc(flow, ksz)  # (B, H, W, K2, 2)
        scores = torch.matmul(key_w, query.unsqueeze(-1))[..., 0] / math.sqrt(c)
        prob = torch.softmax(scores, dim=-1)
        return torch.matmul(prob.unsqueeze(-2), flow_w)[..., 0, :]


# ---------------------------------------------------------------------------
# GRU refinement
# ---------------------------------------------------------------------------


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, out_dim=2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, out_dim, 3, padding=1)

    def forward(self, x):  # NCHW
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(cin, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(cin, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x):  # NCHW
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


def _conv_without_cudnn(conv, x):
    """Run ``conv`` through ATen's im2col + GEMM instead of cuDNN. In float32
    with TF32 off, cuDNN's algorithm choice for the 3x3 convs over 256
    channels at the 1080p matcher's 1/4 scale, (2, 256, 128, 224), runs
    ~215 ms per conv on an H100 (NVIDIA H100 80GB HBM3, 700 W), with or
    without cudnn.benchmark; im2col + GEMM takes ~1.7 ms with the same f32
    math. (cuDNN's TF32 flag set by the context has no effect while cuDNN is
    off.)"""
    with torch.backends.cudnn.flags(enabled=False):
        return conv(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels=81, flow_channels=2):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(flow_channels, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - flow_channels, 3, padding=1)

    def forward(self, flow, corr):  # NCHW
        cor = F.relu(_conv_without_cudnn(self.convc2, F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(_conv_without_cudnn(self.conv, torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels=81, downsample_factor=4, flow_dim=2):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, flow_dim)
        self.gru = SepConvGRU(128, 128 + 128)
        self.flow_head = FlowHead(128, 256, flow_dim)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, downsample_factor**2 * 9, 1),
        )

    def forward(self, net, inp, corr, flow):
        """All NHWC: returns (net, up_mask, delta_flow)."""
        net, inp, corr, flow = (_nchw(t) for t in (net, inp, corr, flow))
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net)
        mask = self.mask(net)
        return _nhwc(net), _nhwc(mask), _nhwc(delta_flow)


def upsample_flow_with_mask(flow, up_mask, upsample_factor):
    """RAFT convex upsampling: (B, H, W, 2) -> (B, H*k, W*k, 2)."""
    b, h, w, _ = flow.shape
    k = upsample_factor
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, k * k), dim=3)
    flow_w = _unfold_nhwc(flow * k, 3)  # (B, H, W, 9, 2)
    up = torch.matmul(mask.transpose(-1, -2), flow_w)  # (B, H, W, k*k, 2)
    up = up.reshape(b, h, w, k, k, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, h * k, w * k, 2)


# ---------------------------------------------------------------------------
# UniMatch core (flow task) + GMFlow wrapper
# ---------------------------------------------------------------------------

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
# The GMFlow pretrained config, one entry per scale (1/8, then 1/4): swin
# splits per side, correlation radius and propagation radius (-1: global).
_ATTN_SPLITS = (2, 8)
_CORR_RADIUS = (-1, 4)
_PROP_RADIUS = (-1, 1)
_CHANNELS = 128
_UPSAMPLE = 4


class UniMatchFlow(nn.Module):
    """Flow-task UniMatch with the GMFlow pretrained config, bidirectional."""

    def __init__(self, num_transformer_layers=6, fused_attention="auto"):
        super().__init__()
        self.backbone = CNNEncoder(_CHANNELS)
        self.transformer = FeatureTransformer(num_transformer_layers, _CHANNELS,
                                              fused_attention=fused_attention)
        self.feature_flow_attn = SelfAttnPropagation(_CHANNELS)
        self.refine_proj = nn.Conv2d(_CHANNELS, 256, 1)
        self.refine = BasicUpdateBlock(81, _UPSAMPLE, 2)

    def extract_feature(self, img0, img1):
        features = self.backbone(torch.cat([img0, img1], dim=0))[::-1]
        f0 = [f.chunk(2, dim=0)[0] for f in features]  # low to high res
        f1 = [f.chunk(2, dim=0)[1] for f in features]
        return f0, f1

    def forward(self, img0, img1, num_reg_refine=6):
        """img0/img1: (B, H, W, 3) in [0, 255]. Returns the final flow
        (2B, H, W, 2) as [forward x B, backward x B]."""
        if num_reg_refine < 1:
            raise ValueError("num_reg_refine must be >= 1")
        mean = torch.tensor(_IMAGENET_MEAN, device=img0.device)
        std = torch.tensor(_IMAGENET_STD, device=img0.device)
        img0 = (img0 / 255.0 - mean) / std
        img1 = (img1 / 255.0 - mean) / std

        feature0_list, feature1_list = self.extract_feature(img0, img1)
        flow = None
        for scale_idx, attn_splits in enumerate(_ATTN_SPLITS):
            feature0, feature1 = feature0_list[scale_idx], feature1_list[scale_idx]
            if scale_idx > 0:
                feature0, feature1 = (torch.cat([feature0, feature1], dim=0),
                                      torch.cat([feature1, feature0], dim=0))
            feature0_ori, feature1_ori = feature0, feature1

            if scale_idx > 0:
                up = resize_bilinear(torch.movedim(flow, -1, 1),
                                     feature0.shape[1:3], align_corners=True)
                flow = torch.movedim(up, 1, -1) * 2.0
                feature1 = flow_warp(feature1, flow)

            feature0, feature1 = feature_add_position(
                feature0, feature1, attn_splits, _CHANNELS
            )
            feature0, feature1 = self.transformer(feature0, feature1, attn_splits)

            corr_radius = _CORR_RADIUS[scale_idx]
            if corr_radius == -1:
                flow_pred = global_correlation_softmax(feature0, feature1, True)[0]
            else:
                flow_pred = local_correlation_softmax(
                    feature0, feature1, corr_radius
                )[0]
            flow = flow + flow_pred if flow is not None else flow_pred

            if scale_idx == 0:
                feature0 = torch.cat([feature0, feature1], dim=0)
            prop_radius = _PROP_RADIUS[scale_idx]
            flow = self.feature_flow_attn(
                feature0, flow, local_window_attn=prop_radius > 0,
                local_window_radius=prop_radius,
            )

        # The GRU state is re-initialised from the same projection at every
        # iteration (reference quirk), so project once.
        net0, inp = _nhwc(self.refine_proj(_nchw(feature0))).chunk(2, dim=-1)
        net0, inp = torch.tanh(net0), F.relu(inp)
        for _ in range(num_reg_refine):
            correlation = local_correlation_with_flow(
                feature0_ori, feature1_ori, flow, local_radius=4
            )
            _, up_mask, residual_flow = self.refine(net0, inp, correlation, flow)
            flow = flow + residual_flow
        return upsample_flow_with_mask(flow, up_mask, _UPSAMPLE)


class GMFlow(UniMatchFlow):
    """Inference wrapper with the reference's resize / bidirectional /
    occlusion protocol. Subclasses the core so the state_dict keeps the
    reference layout (no wrapper prefix)."""

    def __init__(self, num_transformer_layers=6, num_reg_refine=6,
                 fused_attention="auto"):
        super().__init__(num_transformer_layers, fused_attention)
        self.num_reg_refine = num_reg_refine

    def forward(self, img0, img1, inference_size=None):
        """img0/img1: (B, H, W, 3) in [0, 255]. Returns a dict with 'flow'
        and 'flow_bwd' (B, H, W, 2) and the occlusion masks 'fwd_occ' and
        'bwd_occ' (B, H, W, 1). ``inference_size`` (H, W) is the size the
        matcher runs at; None means round up to the next x32. Portrait
        inputs (H > W) run transposed through the matcher and the flow
        components swap back after."""
        if img0.shape[1] > img0.shape[2]:
            out = self(img0.transpose(1, 2), img1.transpose(1, 2),
                       inference_size=inference_size)

            def untranspose(v):
                v = v.transpose(1, 2)
                return v.flip(-1) if v.shape[-1] == 2 else v

            return {k: untranspose(v) for k, v in out.items()}

        b, orig_h, orig_w, _ = img0.shape
        if inference_size is None:
            inf_h, inf_w = -(-orig_h // 32) * 32, -(-orig_w // 32) * 32
        else:
            inf_h, inf_w = inference_size

        def resize(img, hw):
            return torch.movedim(
                resize_bilinear(torch.movedim(img, -1, 1), hw, align_corners=True),
                1, -1,
            )

        if (inf_h, inf_w) != (orig_h, orig_w):
            img0 = resize(img0, (inf_h, inf_w))
            img1 = resize(img1, (inf_h, inf_w))
        flow_pr = super().forward(img0, img1, num_reg_refine=self.num_reg_refine)
        if (inf_h, inf_w) != (orig_h, orig_w):
            flow_pr = resize(flow_pr, (orig_h, orig_w))
            flow_pr = flow_pr * torch.tensor(
                [orig_w / inf_w, orig_h / inf_h], dtype=flow_pr.dtype,
                device=flow_pr.device,
            )
        flow, flow_bwd = flow_pr[:b], flow_pr[b:]
        fwd_occ, bwd_occ = forward_backward_consistency(flow, flow_bwd)
        return {"flow": flow, "flow_bwd": flow_bwd,
                "fwd_occ": fwd_occ[..., None], "bwd_occ": bwd_occ[..., None]}
