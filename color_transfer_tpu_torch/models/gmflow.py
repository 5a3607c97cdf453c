"""GMFlow / UniMatch optical-flow matcher (flow task) in PyTorch.

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

Mixed precision (the JAX package's knobs; None is float32 throughout):
  * ``compute_dtype``: the backbone's convs and the transformer compute in
    this dtype as flax's ``dtype=`` does (inputs and weights cast, the
    output in the dtype, a bias cast and added in it, the parameters f32);
    InstanceNorm statistics, the attention's scores and softmax and the
    LayerNorm statistics stay f32. "auto" fuses the transformer exactly in
    bfloat16;
  * ``refine_dtype``: SelfAttnPropagation's dtype (else compute_dtype), and
    when set, the transformer's output features and the GRU loop's
    features are cast to it (the "refine32" recipe pins the flow arithmetic
    to f32);
  * ``corr_dtype``: the GRU loop's correlation (kernel B1) in this dtype,
    unless refine_dtype overrides it.
The correlation softmaxes take the features in whatever dtype they arrive
in, with f32 products and sums; refine_proj and the update block stay f32.
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
from color_transfer_tpu_torch.models.layers import (
    REDUCED,
    conv_in,
    dense_in,
    reduced_dtype,
    widen,
)
from color_transfer_tpu_torch.models.gmflow_extras import full_attention_1d, swin_attention_1d
from color_transfer_tpu_torch.ops.local_corr import local_correlation_with_flow
from color_transfer_tpu_torch.ops.win_attention import (
    eligible,
    ffn_eligible,
    ffn_fused,
    layer_norm,
    window_attention_fused,
    window_attention_plain,
    window_sublayer_fused,
)
from color_transfer_tpu_torch.parallel.mesh import axis_stack, axis_sum
from color_transfer_tpu_torch.parallel.tensor_parallel import current_axis
from color_transfer_tpu_torch.utils import profiling


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _gelu(x):
    """Exact GELU; in a reduced dtype op by op, 0.5 x erfc(-x sqrt(1/2))
    rounded after each op as jax.nn.gelu(approximate=False) computes on a
    bf16 array."""
    if x.dtype not in REDUCED:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _instance_norm(norm, x):
    """InstanceNorm with f32 statistics, the output in x's dtype (the JAX
    package's _InstanceNorm)."""
    return norm(x.float()).to(x.dtype) if x.dtype in REDUCED else norm(x)


# ---------------------------------------------------------------------------
# CNN encoder
# ---------------------------------------------------------------------------


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1, dtype=None):
        super().__init__()
        self.dtype = dtype
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
        dt = self.dtype
        y = F.relu(_instance_norm(self.norm1, conv_in(self.conv1, x, dt)))
        y = F.relu(_instance_norm(self.norm2, conv_in(self.conv2, y, dt)))
        if self.downsample is not None:
            x = _instance_norm(self.downsample[1], conv_in(self.downsample[0], x, dt))
        return F.relu(x + y)


class _TridentConv(nn.Module):
    """One 3x3 weight applied at strides 1 and 2 (no bias)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        return [F.conv2d(x, w, stride=s, padding=1) for s in (1, 2)]


class CNNEncoder(nn.Module):
    """RAFT-style encoder emitting the 1/4 and 1/8 scales through the
    shared-weight trident conv. NHWC in, list of NHWC out (high to low
    resolution). ``dtype``: the convs' compute dtype (the input is cast to
    it first); None is float32."""

    def __init__(self, output_dim=128, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.norm1 = nn.InstanceNorm2d(64, eps=1e-5)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, dtype=dtype),
                                    ResidualBlock(64, 64, dtype=dtype))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2, dtype),
                                    ResidualBlock(96, 96, dtype=dtype))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, dtype=dtype),
                                    ResidualBlock(128, 128, dtype=dtype))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        self.trident_conv = _TridentConv(output_dim)

    def forward(self, x):
        dt = self.dtype
        if reduced_dtype(dt) is not None:
            x = x.to(dt)
        x = F.relu(_instance_norm(self.norm1, conv_in(self.conv1, _nchw(x), dt)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = conv_in(self.conv2, x, dt)
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
    """Add the sine embedding per split window, in the features' dtype."""
    b, h, w, c = feature0.shape
    s = max(attn_splits, 1)
    pos = torch.from_numpy(_sine_position(h // s, w // s, channels // 2))
    pos = pos.to(feature0.device).repeat(s, s, 1).to(feature0.dtype)  # tiled on the device
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


def swin_attention(q, k, v, num_splits, with_shift, h, w):
    """Split-window attention with the optional swin shift on (B, H*W, C)
    tokens (the JAX package's ``swin_attention``; the token-major routes'
    self-attention). ``v`` may hold fewer channels than q and k (a
    tensor-parallel slice)."""
    if num_splits <= 1:
        return window_attention_plain(q, k, v)
    b = q.shape[0]
    hs, ws = h // num_splits, w // num_splits

    def windows(x):
        x = x.reshape(b, h, w, x.shape[-1])
        if with_shift:
            x = torch.roll(x, (-(hs // 2), -(ws // 2)), dims=(1, 2))
        return split_windows(x, num_splits).reshape(-1, hs * ws, x.shape[-1])

    mask = shift_window_mask(h, w, num_splits, q.device) if with_shift else None
    out = window_attention_plain(windows(q), windows(k), windows(v), mask)
    out = merge_windows(out.reshape(-1, hs, ws, out.shape[-1]), num_splits)
    if with_shift:
        out = torch.roll(out, (hs // 2, ws // 2), dims=(1, 2))
    return out.reshape(b, h * w, -1)


def _gather_features(x, axis):
    """Every rank's feature slice of ``x`` joined in rank order: the whole
    features (column-parallel outputs gathered)."""
    stacked = axis_stack(x, axis).movedim(0, -2)
    return stacked.reshape(*x.shape[:-1], -1)


def _row_dense(lin, x, dtype, axis):
    """``dense_in`` of a row-parallel layer: this rank's slice of the
    product summed over the tensor-parallel ``axis`` (None: the whole
    product). In a reduced dtype the bf16 operands' products are summed in
    f32 and the sum rounded once, as the unsharded product rounds."""
    if axis is None:
        return dense_in(lin, x, dtype)
    dtype = reduced_dtype(dtype)
    if dtype is None:
        return axis_sum(F.linear(x, lin.weight), axis)
    partial = F.linear(x.to(dtype).float(), lin.weight.to(dtype).float())
    return axis_sum(partial, axis).to(dtype)


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
    the same on every route. ``dtype``: the compute dtype (flax's
    ``dtype=``; None is float32): the products' operands cast to it and
    their outputs in it, LayerNorm's statistics f32 and its output in it.
    On the fused route the weights are cast to it and the LayerNorm
    parameters stay f32, as the JAX package passes them.

    Inside ``parallel.tensor_parallel.tensor_parallel(axis)`` the layer
    holds this rank's slices of q/k/v, ``mlp.0`` (output features) and
    ``merge``, ``mlp.2`` (input features): it gathers q and k, attends with
    its slice of v, and sums the row-parallel products over the axis. The
    fused ops take whole weight matrices, so "auto" runs unfused there and
    True raises."""

    def __init__(self, d_model=128, no_ffn=False, ffn_dim_expansion=4,
                 fused_attention="auto", dtype=None):
        super().__init__()
        self.dtype = reduced_dtype(dtype)
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
                windowed=False, attend=None):
        """``mask``: the (k*k, L, L) shift mask or None; ``shift_windows``:
        the same mask as its geometry (k, hs, ws), which the fused ops read;
        ``windowed``: the tokens are split into more than one window;
        ``attend``: the attention core on (q, k, v) of token-major tokens
        (FeatureTransformer's routes other than window-major swin), which
        runs unfused."""
        dt = self.dtype
        if dt is not None:
            source, target = source.to(dt), target.to(dt)
        tp = current_axis()
        fused = self.fused_attention
        if tp is not None and fused is True:
            raise ValueError(
                "fused_attention=True under tensor parallelism: the fused window "
                "kernels take whole weight matrices (parallel/tensor_parallel.py)")
        if fused == "auto":
            fused = source.dtype == torch.bfloat16 and tp is None
        fused = fused and windowed and attend is None
        d = self.merge.weight.shape[0]
        tokens = (*source.shape[:-1], d)
        same_width = source.shape[-1] == d

        def weight(*ws):  # input-major, in the compute dtype
            w = torch.cat(ws).t()
            return w if dt is None else w.to(dt)

        def norm(ln, x):  # LayerNorm: f32 statistics, the output in dt
            return ln(x) if dt is None else layer_norm(x, ln.weight, ln.bias)

        if fused and same_width and eligible(tokens, source.dtype):
            # The weights in JAX's input-major layout, [W_k | W_v] joined.
            message = window_sublayer_fused(
                source, target, weight(self.q_proj.weight),
                weight(self.k_proj.weight, self.v_proj.weight),
                weight(self.merge.weight), self.norm1.weight, self.norm1.bias,
                shift_windows=shift_windows, add_residual=self.no_ffn,
            )
            if self.no_ffn:
                return message  # source + LN1(sublayer), the whole layer
        else:
            q = dense_in(self.q_proj, source, dt)
            k = dense_in(self.k_proj, target, dt)
            v = dense_in(self.v_proj, target, dt)
            if tp is not None:  # one head: the scores need the whole q and k
                q, k = _gather_features(q, tp), _gather_features(k, tp)
            if attend is not None:
                message = attend(q, k, v)
            elif fused and eligible(q.shape, q.dtype):
                message = window_attention_fused(q, k, v, shift_windows=shift_windows)
            else:
                # The (k*k, L, L) mask repeats over the window batch; the
                # JAX package's _attention (f32 scores and softmax).
                message = window_attention_plain(q, k, v, mask)
            message = norm(self.norm1, _row_dense(self.merge, message, dt, tp))
        if not self.no_ffn:
            w0, w2 = self.mlp[0].weight, self.mlp[2].weight
            if fused and same_width and ffn_eligible(tokens, source.dtype, w0.shape[0]):
                return ffn_fused(source, message, weight(w0), weight(w2), self.norm2.weight,
                                 self.norm2.bias, add_residual=True)
            message = dense_in(self.mlp[0], torch.cat([source, message], dim=-1), dt)
            message = _row_dense(self.mlp[2], _gelu(message), dt, tp)
            message = norm(self.norm2, message)
        return source + message


class TransformerBlock(nn.Module):
    """self-attn (no FFN) + cross-attn + FFN."""

    def __init__(self, d_model=128, ffn_dim_expansion=4, fused_attention="auto",
                 dtype=None):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, True, ffn_dim_expansion,
                                          fused_attention, dtype)
        self.cross_attn_ffn = TransformerLayer(d_model, False, ffn_dim_expansion,
                                               fused_attention, dtype)

    def forward(self, source, target, mask=None, *, shift_windows=None,
                windowed=False, attends=(None, None)):
        """``attends``: the self- and the cross-attention's cores on the
        token-major routes (TransformerLayer's ``attend``)."""
        route = {"shift_windows": shift_windows, "windowed": windowed}
        source = self.self_attn(source, source, mask, **route, attend=attends[0])
        return self.cross_attn_ffn(source, target, mask, **route, attend=attends[1])


def _swap_halves(x):
    half0, half1 = x.chunk(2, dim=0)
    return torch.cat([half1, half0], dim=0)


ATTN_TYPES = ("swin", "self_swin2d_cross_1d", "self_swin2d_cross_swin1d")


class FeatureTransformer(nn.Module):
    """TransformerBlocks over the [f0|f1] / [f1|f0] siamese batch. The
    cross-attention target is a batch-half swap of the source. ``dtype``:
    the features are cast to it and the layers compute in it.

    ``attn_type`` routes the attention as the JAX package does (reference
    unimatch/transformer.py:65-138): "swin" (the flow task) runs
    window-major: tokens stay in (2B*k*k, hs*ws, C) windows and odd
    (shifted) layers roll the image by half a window before and after. The
    stereo types run token-major on (2B, H*W, C): self-attention in 2D
    shifted windows (``swin_attention``), cross-attention along the rows,
    over the whole row ("self_swin2d_cross_1d") or in 1D shifted windows
    ("self_swin2d_cross_swin1d"; the whole row at one split); these run
    unfused."""

    def __init__(self, num_layers=6, d_model=128, ffn_dim_expansion=4,
                 fused_attention="auto", dtype=None):
        super().__init__()
        self.dtype = reduced_dtype(dtype)
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, ffn_dim_expansion, fused_attention, dtype)
            for _ in range(num_layers)
        )

    def forward(self, feature0, feature1, attn_num_splits, attn_type="swin"):
        """(B, H, W, C) x2 -> (B, H, W, C) x2."""
        if attn_type not in ATTN_TYPES:
            raise ValueError(f"unknown attn_type {attn_type!r}")
        if self.dtype is not None:
            feature0, feature1 = feature0.to(self.dtype), feature1.to(self.dtype)
        if attn_type != "swin":
            return self._token_major(feature0, feature1, attn_num_splits, attn_type)
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

    def _token_major(self, feature0, feature1, k, attn_type):
        b, h, w, c = feature0.shape
        src = torch.cat([feature0.reshape(b, h * w, c), feature1.reshape(b, h * w, c)])
        for i, layer in enumerate(self.layers):
            shift = k > 1 and i % 2 == 1

            def self_attend(q, kk, v, shift=shift):
                return swin_attention(q, kk, v, k, shift, h, w)

            def cross_attend(q, kk, v, shift=shift):
                if attn_type == "self_swin2d_cross_swin1d" and k > 1:
                    return swin_attention_1d(q, kk, v, k, shift, h, w)
                return full_attention_1d(q, kk, v, h, w)

            src = layer(src, _swap_halves(src), attends=(self_attend, cross_attend))
        f0, f1 = src.chunk(2, dim=0)
        return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Correlation / matching
# ---------------------------------------------------------------------------


def global_correlation_softmax(feature0, feature1, pred_bidir_flow=False):
    """All-pairs correlation -> softmax -> expected coords -> flow.
    Bidirectional output is block-concat [forward x B, backward x B].
    Returns (flow (B', H, W, 2), prob (B', HW, HW))."""
    b, h, w, c = feature0.shape
    f0 = widen(feature0.reshape(b, h * w, c))  # bf16 products are exact in f32
    f1 = widen(feature1.reshape(b, h * w, c))
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
    feature0, feature1 = widen(feature0), widen(feature1)  # f32 products and sums
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
    """``dtype``: the projections' compute dtype (flax's Dense ``dtype=``);
    the scores are f32 sums of their products, the softmax and the flow
    f32."""

    def __init__(self, in_channels=128, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature0, flow, local_window_attn=False,
                local_window_radius=1):
        b, h, w, c = feature0.shape
        query = dense_in(self.q_proj, feature0, self.dtype)
        if not local_window_attn:
            # Reference quirk kept for checkpoint parity: in the global path
            # the key is a projection of the already-projected query.
            key = dense_in(self.k_proj, query, self.dtype)
            q = widen(query.reshape(b, h * w, c))
            k = widen(key.reshape(b, h * w, c))
            v = flow.reshape(b, h * w, flow.shape[-1])
            scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
            return out.reshape(b, h, w, flow.shape[-1])
        key = dense_in(self.k_proj, feature0, self.dtype)
        ksz = 2 * local_window_radius + 1
        key_w = widen(_unfold_nhwc(key, ksz))  # (B, H, W, K2, C)
        flow_w = _unfold_nhwc(flow, ksz)  # (B, H, W, K2, 2)
        scores = torch.matmul(key_w, widen(query).unsqueeze(-1))[..., 0] / math.sqrt(c)
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
    """Flow-task UniMatch with the GMFlow pretrained config, bidirectional.
    ``corr_dtype``, ``compute_dtype`` and ``refine_dtype``: the JAX
    package's precision knobs (torch dtypes; the module docstring)."""

    def __init__(self, num_transformer_layers=6, fused_attention="auto",
                 corr_dtype=torch.float32, compute_dtype=None, refine_dtype=None):
        super().__init__()
        self.corr_dtype = corr_dtype
        self.compute_dtype = compute_dtype
        self.refine_dtype = refine_dtype
        self.backbone = CNNEncoder(_CHANNELS, dtype=compute_dtype)
        self.transformer = FeatureTransformer(num_transformer_layers, _CHANNELS,
                                              fused_attention=fused_attention,
                                              dtype=compute_dtype)
        self.feature_flow_attn = SelfAttnPropagation(
            _CHANNELS, dtype=refine_dtype if refine_dtype is not None else compute_dtype)
        self.refine_proj = nn.Conv2d(_CHANNELS, 256, 1)
        self.refine = BasicUpdateBlock(81, _UPSAMPLE, 2)

    def extract_feature(self, img0, img1):
        with profiling.annotate("gmflow.backbone"):
            features = self.backbone(torch.cat([img0, img1], dim=0))[::-1]
        f0 = [f.chunk(2, dim=0)[0] for f in features]  # low to high res
        f1 = [f.chunk(2, dim=0)[1] for f in features]
        return f0, f1

    def scale_step(self, scale_idx, feature0, feature1, flow):
        """One scale of the matcher: the backbone's features of the scale
        (B, h, w, C) each and the previous scale's flow (None at the first)
        -> (flow, feature0, feature0_ori, feature1_ori): the scale's flow
        after the propagation, the transformer's feature0 (both directions)
        and the scale's backbone features (both directions), in the dtypes
        the GRU loop takes them."""
        attn_splits = _ATTN_SPLITS[scale_idx]
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
        with profiling.annotate("gmflow.transformer"):
            feature0, feature1 = self.transformer(feature0, feature1, attn_splits)
        with profiling.annotate("gmflow.match"):
            if self.refine_dtype is not None:
                # The selective recipe: the flow arithmetic downstream of the
                # transformer in refine_dtype.
                feature0, feature1, feature0_ori, feature1_ori = (
                    t.to(self.refine_dtype)
                    for t in (feature0, feature1, feature0_ori, feature1_ori))

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
            return flow, feature0, feature0_ori, feature1_ori

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
        for scale_idx in range(len(_ATTN_SPLITS)):
            flow, feature0, feature0_ori, feature1_ori = self.scale_step(
                scale_idx, feature0_list[scale_idx], feature1_list[scale_idx], flow)

        # The GRU state is re-initialised from the same projection at every
        # iteration (reference quirk), so project once; refine_proj and the
        # update block are f32 whatever the features' dtype.
        net0, inp = _nhwc(self.refine_proj(_nchw(widen(feature0)))).chunk(2, dim=-1)
        net0, inp = torch.tanh(net0), F.relu(inp)
        corr_dtype = self.refine_dtype if self.refine_dtype is not None else self.corr_dtype
        for _ in range(num_reg_refine):
            with profiling.annotate("gmflow.refine"):
                correlation = local_correlation_with_flow(
                    feature0_ori, feature1_ori, flow, local_radius=4, corr_dtype=corr_dtype
                )
                _, up_mask, residual_flow = self.refine(net0, inp, correlation, flow)
                flow = flow + residual_flow
        return upsample_flow_with_mask(flow, up_mask, _UPSAMPLE)


class GMFlow(UniMatchFlow):
    """Inference wrapper with the reference's resize / bidirectional /
    occlusion protocol. Subclasses the core so the state_dict keeps the
    reference layout (no wrapper prefix)."""

    def __init__(self, num_transformer_layers=6, num_reg_refine=6,
                 fused_attention="auto", corr_dtype=torch.float32, compute_dtype=None,
                 refine_dtype=None):
        super().__init__(num_transformer_layers, fused_attention, corr_dtype,
                         compute_dtype, refine_dtype)
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
