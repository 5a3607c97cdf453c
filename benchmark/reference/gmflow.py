"""GMFlow (UniMatch's flow task, the pretrained GMFlow configuration) in
plain float32 torch: bidirectional flow and the forward/backward occlusion
masks. Parameter names follow the reference layout, so one state_dict
serves this model and the measured one.

Two scales (1/8, then 1/4): CNN backbone, sine position, a swin
transformer of 6 blocks (self-attention, cross-attention + FFN), global then
local correlation softmax, self-attention flow propagation, then 6 GRU
refinements at 1/4 scale on the flow-displaced local correlation, and RAFT's
convex upsampling."""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import without_cudnn
from benchmark.reference.ops import (
    coords_grid,
    flow_warp,
    forward_backward_consistency,
    local_correlation_with_flow,
    resize_bilinear,
)

ATTN_SPLITS, CORR_RADIUS, PROP_RADIUS = (2, 8), (-1, 4), (-1, 1)
CHANNELS, UPSAMPLE = 128, 4
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.norm1 = nn.InstanceNorm2d(cout, eps=1e-5)
        self.norm2 = nn.InstanceNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride),
                                            nn.InstanceNorm2d(cout, eps=1e-5))

    def forward(self, x):
        y = F.relu(self.norm2(self.conv2(F.relu(self.norm1(self.conv1(x))))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class TridentConv(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x):
        return [F.conv2d(x, self.weight, stride=s, padding=1) for s in (1, 2)]


class CNNEncoder(nn.Module):
    def __init__(self, dim=CHANNELS):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.norm1 = nn.InstanceNorm2d(64, eps=1e-5)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64), ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2), ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128), ResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(128, dim, 1)
        self.trident_conv = TridentConv(dim)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(_nchw(x))))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        return [_nhwc(y) for y in self.trident_conv(x)]


def sine_position(h, w, device, num_pos_feats=64, temperature=10000, scale=2 * math.pi):
    """DETR's sine embedding on an all-ones mask, (H, W, 2 * num)."""
    eps = 1e-6
    y = np.cumsum(np.ones((h, w)), axis=0)
    x = np.cumsum(np.ones((h, w)), axis=1)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_pos_feats, dtype=np.float64) // 2) / num_pos_feats)

    def embed(e):
        p = e[:, :, None] / dim_t
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], axis=-1).reshape(h, w, -1)

    pos = np.concatenate([embed(y), embed(x)], axis=-1).astype(np.float32)
    return torch.from_numpy(pos).to(device)


def split_windows(x, k):
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x, k):
    bk, hs, ws, c = x.shape
    x = x.reshape(bk // (k * k), k, k, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bk // (k * k), k * hs, k * ws, c)


def shift_window_mask(h, w, k, device):
    """The additive (-100 / 0) mask of the shifted windows, (k*k, L, L)."""
    hs, ws = h // k, w // k
    sh, sw = hs // 2, ws // 2
    img = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    for hsl in (slice(0, -hs), slice(-hs, -sh), slice(-sh, None)):
        for wsl in (slice(0, -ws), slice(-ws, -sw), slice(-sw, None)):
            img[hsl, wsl] = cnt
            cnt += 1
    win = torch.from_numpy(img.reshape(k, hs, k, ws).transpose(0, 2, 1, 3).reshape(k * k, hs * ws))
    win = win.to(device)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


def attention(q, k, v, mask=None):
    """softmax(q k^T / sqrt(C) + mask) v per window; the mask repeats over
    the window batch."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        n = mask.shape[0]
        scores = (scores.reshape(-1, n, *scores.shape[1:]) + mask).reshape(scores.shape)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


class TransformerLayer(nn.Module):
    def __init__(self, d=CHANNELS, no_ffn=False, expansion=4):
        super().__init__()
        self.no_ffn = no_ffn
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        if not no_ffn:
            self.mlp = nn.Sequential(nn.Linear(2 * d, 2 * d * expansion, bias=False), nn.GELU(),
                                     nn.Linear(2 * d * expansion, d, bias=False))
            self.norm2 = nn.LayerNorm(d, eps=1e-6)

    def forward(self, source, target, mask=None):
        message = attention(self.q_proj(source), self.k_proj(target), self.v_proj(target), mask)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            message = self.norm2(self.mlp(torch.cat([source, message], dim=-1)))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d=CHANNELS):
        super().__init__()
        self.self_attn = TransformerLayer(d, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(d)

    def forward(self, source, target, mask=None):
        return self.cross_attn_ffn(self.self_attn(source, source, mask), target, mask)


def _swap_halves(x):
    a, b = x.chunk(2, dim=0)
    return torch.cat([b, a], dim=0)


class FeatureTransformer(nn.Module):
    """Window-major swin attention over the [f0 | f1] siamese batch; odd
    layers roll the image by half a window before and after."""

    def __init__(self, num_layers=6, d=CHANNELS):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(d) for _ in range(num_layers))

    def forward(self, f0, f1, k):
        b, h, w, c = f0.shape
        hs, ws = h // k, w // k

        def to_win(img):
            return split_windows(img, k).reshape(-1, hs * ws, c)

        def from_win(tokens):
            return merge_windows(tokens.reshape(-1, hs, ws, c), k)

        mask = shift_window_mask(h, w, k, f0.device) if k > 1 else None
        src = to_win(torch.cat([f0, f1], dim=0))
        for i, layer in enumerate(self.layers):
            shifted = k > 1 and i % 2 == 1
            if shifted:
                src = to_win(torch.roll(from_win(src), (-(hs // 2), -(ws // 2)), dims=(1, 2)))
            src = layer(src, _swap_halves(src), mask if shifted else None)
            if shifted:
                src = to_win(torch.roll(from_win(src), (hs // 2, ws // 2), dims=(1, 2)))
        return from_win(src).chunk(2, dim=0)


def global_correlation_softmax(f0, f1):
    """All-pairs correlation, softmax, expected position -> flow, for
    [forward x B, backward x B]."""
    b, h, w, c = f0.shape
    corr = torch.matmul(f0.reshape(b, h * w, c), f1.reshape(b, h * w, c).transpose(1, 2))
    corr = corr / math.sqrt(c)
    grid = coords_grid(h, w, device=f0.device).reshape(h * w, 2)
    corr = torch.cat([corr, corr.transpose(1, 2)], dim=0)
    flow = torch.matmul(torch.softmax(corr, dim=-1), grid)
    return flow.reshape(2 * b, h, w, 2) - grid.reshape(1, h, w, 2)


def local_correlation_softmax(f0, f1, r):
    """Windowed correlation softmax over the (2r+1)^2 integer offsets, zero
    padded, out-of-image offsets masked -> flow."""
    b, h, w, c = f0.shape
    coords = coords_grid(h, w, device=f0.device)
    padded = F.pad(f1, (0, 0, r, r, r, r))
    corr, valid, offsets = [], [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            corr.append((f0 * padded[:, r + dy:r + dy + h, r + dx:r + dx + w]).sum(-1))
            x, y = coords[..., 0] + dx, coords[..., 1] + dy
            valid.append((x >= 0) & (x < w) & (y >= 0) & (y < h))
            offsets.append((dx, dy))
    corr = torch.where(torch.stack(valid, -1), torch.stack(corr, -1) / math.sqrt(c), -1e9)
    prob = torch.softmax(corr, dim=-1)
    sample = coords[:, :, None, :] + torch.tensor(offsets, dtype=torch.float32, device=f0.device)
    return torch.einsum("bhwk,hwkt->bhwt", prob, sample) - coords


def unfold_nhwc(x, size):
    """Zero-padded size^2 neighbourhoods, (B, H, W, K2, C), row-major."""
    r = size // 2
    b, h, w, c = x.shape
    p = F.pad(x, (0, 0, r, r, r, r))
    return torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(size) for dx in range(size)],
                       dim=3)


class SelfAttnPropagation(nn.Module):
    def __init__(self, c=CHANNELS):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)

    def forward(self, feature, flow, radius):
        b, h, w, c = feature.shape
        query = self.q_proj(feature)
        if radius <= 0:
            # The reference's key is a projection of the projected query.
            key = self.k_proj(query)
            scores = torch.matmul(query.reshape(b, h * w, c),
                                  key.reshape(b, h * w, c).transpose(1, 2)) / math.sqrt(c)
            out = torch.matmul(torch.softmax(scores, dim=-1), flow.reshape(b, h * w, 2))
            return out.reshape(b, h, w, 2)
        size = 2 * radius + 1
        key_w = unfold_nhwc(self.k_proj(feature), size)
        scores = torch.matmul(key_w, query.unsqueeze(-1))[..., 0] / math.sqrt(c)
        return torch.matmul(torch.softmax(scores, dim=-1).unsqueeze(-2),
                            unfold_nhwc(flow, size))[..., 0, :]


class FlowHead(nn.Module):
    def __init__(self, cin=128, hidden=256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    def __init__(self, hidden=128, cin=256):
        super().__init__()
        n = hidden + cin
        self.convz1 = nn.Conv2d(n, hidden, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(n, hidden, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(n, hidden, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(n, hidden, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(n, hidden, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(n, hidden, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        for cz, cr, cq in ((self.convz1, self.convr1, self.convq1),
                           (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z, r = torch.sigmoid(cz(hx)), torch.sigmoid(cr(hx))
            h = (1 - z) * h + z * torch.tanh(cq(torch.cat([r * h, x], dim=1)))
        return h


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(81, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(without_cudnn(self.convc2, F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(without_cudnn(self.conv, torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(128, 256)
        self.flow_head = FlowHead(128, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True),
                                  nn.Conv2d(256, UPSAMPLE ** 2 * 9, 1))

    def forward(self, net, inp, corr, flow):
        net, inp, corr, flow = (_nchw(t) for t in (net, inp, corr, flow))
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], dim=1))
        return _nhwc(self.mask(net)), _nhwc(self.flow_head(net))


def upsample_flow_with_mask(flow, up_mask, k):
    """RAFT's convex upsampling, (B, H, W, 2) -> (B, kH, kW, 2)."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(up_mask.reshape(b, h, w, 9, k * k), dim=3)
    up = torch.matmul(mask.transpose(-1, -2), unfold_nhwc(flow * k, 3))
    return up.reshape(b, h, w, k, k, 2).permute(0, 1, 3, 2, 4, 5).reshape(b, h * k, w * k, 2)


class GMFlow(nn.Module):
    def __init__(self, num_transformer_layers=6, num_reg_refine=6):
        super().__init__()
        self.num_reg_refine = num_reg_refine
        self.backbone = CNNEncoder()
        self.transformer = FeatureTransformer(num_transformer_layers)
        self.feature_flow_attn = SelfAttnPropagation()
        self.refine_proj = nn.Conv2d(CHANNELS, 256, 1)
        self.refine = BasicUpdateBlock()

    def _flow(self, img0, img1):
        """img0/img1 (B, H, W, 3) in [0, 255] at the matcher's size -> the
        flow [forward x B, backward x B] at that size."""
        mean = torch.tensor(IMAGENET_MEAN, device=img0.device)
        std = torch.tensor(IMAGENET_STD, device=img0.device)
        feats = self.backbone(torch.cat([(img0 / 255.0 - mean) / std,
                                         (img1 / 255.0 - mean) / std], dim=0))[::-1]
        flow = None
        for s, feat in enumerate(feats):
            f0, f1 = feat.chunk(2, dim=0)
            if s > 0:
                f0, f1 = torch.cat([f0, f1], dim=0), torch.cat([f1, f0], dim=0)
            f0_ori, f1_ori = f0, f1
            if s > 0:
                up = resize_bilinear(torch.movedim(flow, -1, 1), f0.shape[1:3], align_corners=True)
                flow = torch.movedim(up, 1, -1) * 2.0
                f1 = flow_warp(f1, flow)
            k = ATTN_SPLITS[s]
            _, h, w, _ = f0.shape
            pos = sine_position(h // k, w // k, f0.device).repeat(k, k, 1)
            f0, f1 = self.transformer(f0 + pos, f1 + pos, k)
            if CORR_RADIUS[s] == -1:
                pred = global_correlation_softmax(f0, f1)
            else:
                pred = local_correlation_softmax(f0, f1, CORR_RADIUS[s])
            flow = pred if flow is None else flow + pred
            if s == 0:
                f0 = torch.cat([f0, f1], dim=0)
            flow = self.feature_flow_attn(f0, flow, PROP_RADIUS[s])
        net, inp = _nhwc(self.refine_proj(_nchw(f0))).chunk(2, dim=-1)
        net, inp = torch.tanh(net), F.relu(inp)
        for _ in range(self.num_reg_refine):
            corr = local_correlation_with_flow(f0_ori, f1_ori, flow, 4)
            up_mask, residual = self.refine(net, inp, corr, flow)
            flow = flow + residual
        return upsample_flow_with_mask(flow, up_mask, UPSAMPLE)

    def forward(self, img0, img1, size):
        """img0/img1 (B, H, W, 3) in [0, 255], landscape; ``size`` the
        matcher's (h, w) -> {'flow', 'flow_bwd', 'fwd_occ', 'bwd_occ'}."""
        b, h, w, _ = img0.shape

        def resize(x, hw):
            return torch.movedim(resize_bilinear(torch.movedim(x, -1, 1), hw, True), 1, -1)

        if tuple(size) != (h, w):
            img0, img1 = resize(img0, size), resize(img1, size)
        flow = self._flow(img0, img1)
        if tuple(size) != (h, w):
            flow = resize(flow, (h, w)) * torch.tensor([w / size[1], h / size[0]],
                                                       device=flow.device)
        fwd, bwd = flow[:b], flow[b:]
        fwd_occ, bwd_occ = forward_backward_consistency(fwd, bwd)
        return {"flow": fwd, "flow_bwd": bwd, "fwd_occ": fwd_occ[..., None],
                "bwd_occ": bwd_occ[..., None]}
