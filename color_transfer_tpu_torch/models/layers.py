"""Shared building blocks: DCMCS3DI's Conv and ResB, and flax's ``dtype=``
semantics for any torch conv or linear layer (``conv_in``, ``dense_in``).

Port of color_transfer_tpu/models/layers.py. Modules take and return NHWC
tensors; the convolutions run on permuted (channels-last) views. Parameter
names follow the reference torch layout (``weight``/``bias`` of a Conv2d;
a ResB's convs are ``body.0`` and ``body.2``), the layout
color_transfer_tpu's ``convert_dcmcs3di`` reads.

``dtype`` is the compute dtype, as flax's ``dtype=``: parameters stay
float32, the input, kernel and bias are cast to it, and the conv's output
and the bias add are rounded to it. None keeps float32.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from color_transfer_tpu_torch.core.precision import (
    current_reduced_route,
    reduced_conv_route,
    routed_conv2d,
)
from color_transfer_tpu_torch.ops.conv3x3 import LEAKY_SLOPE, WEIGHT_SHAPE, conv3x3, resb
from color_transfer_tpu_torch.parallel.row_attention_sp import conv2d_rows, current_row_shard


def init_uniform_(conv, generator):
    """The JAX package's init (torch's Conv2d default): kernel and bias both
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = kh * kw * C_in, drawn from
    ``generator``."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)


class Conv(nn.Conv2d):
    """Conv2d with 'same' zero padding (k // 2), stride 1, on NHWC."""

    def __init__(self, in_channels, out_channels, kernel_size=3, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        return conv(x, self.weight, self.bias, self.padding, self.compute_dtype)


def conv(x, weight, bias, padding, compute_dtype=None):
    """``Conv.forward`` on explicit weights: NHWC ``x``, an OIHW ``weight``.
    Without a compute dtype the conv runs in the weights' dtype (float32; a
    float64 reference run passes float64 weights). Inside
    ``parallel.row_attention_sp.row_shard`` ``x`` holds this rank's rows of
    the image and the conv takes its row halos from the neighbours; a
    reduced-precision conv takes ``core.precision.reduced_conv_route``'s
    backend. A call that ``takes_conv3x3`` goes to ``ops.conv3x3``."""
    if compute_dtype in (None, torch.float32):
        x = x.to(weight.dtype)
        if takes_conv3x3(x, weight, padding):
            return conv3x3(x, weight, bias)
    x = x.permute(0, 3, 1, 2)
    rows = current_row_shard()
    if compute_dtype in (None, torch.float32):
        if rows is None:
            return F.conv2d(x, weight, bias, padding=padding).permute(0, 2, 3, 1)
        y = conv2d_rows(x, weight, padding, rows)
        return (y + bias[:, None, None]).permute(0, 2, 3, 1)
    cd = compute_dtype
    x, weight = x.to(cd), weight.to(cd)
    y = (routed_conv2d(x, weight, padding) if rows is None
         else conv2d_rows(x, weight, padding, rows))
    return (y + bias.to(cd)[:, None, None]).permute(0, 2, 3, 1)


def takes_conv3x3(x, weight, padding):
    """Whether ``conv`` runs a float32 call through ``ops.conv3x3.conv3x3``
    (the implicit-GEMM kernels on a CUDA tensor, their plain version on a
    CPU tensor): float32 weights of (64, 64, 3, 3), padding 1, no row shard,
    and cuDNN off, which is ATen's route, the one both training steps set
    for their f32 convolutions. A float64 reference run, cuDNN's route (f32
    inference outside ``takes_resb``'s blocks) and every other shape keep
    F.conv2d. ``padding`` as F.conv2d takes it: an int or a pair."""
    pad = tuple(padding) if isinstance(padding, (tuple, list)) else (padding, padding)
    return (x.device.type in ("cuda", "cpu") and weight.dtype == torch.float32
            and tuple(weight.shape) == WEIGHT_SHAPE and pad == (1, 1)
            and current_row_shard() is None and not torch.backends.cudnn.enabled)


def takes_resb(x, c0, c1):
    """Whether ``ResB.forward`` runs its block through ``ops.conv3x3.resb``
    (on a CUDA tensor two conv3x3 launches with the LeakyReLU and the
    residual add in their epilogues, on a CPU tensor its plain version):
    autograd records nothing for the block (grad mode off, or neither ``x``
    nor a weight or bias requires grad), ``x`` and both convs float32 with
    no reduced compute dtype, both (64, 64, 3, 3) with padding 1, no row
    shard. Training, a float64 reference run, a bf16 stack and the
    row-sharded evaluation keep ``conv``'s route."""
    leaves = (x, c0.weight, c0.bias, c1.weight, c1.bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return False
    return (x.device.type in ("cuda", "cpu") and all(t.dtype == torch.float32 for t in leaves)
            and all(c.compute_dtype in (None, torch.float32)
                    and tuple(c.weight.shape) == WEIGHT_SHAPE and tuple(c.padding) == (1, 1)
                    for c in (c0, c1))
            and current_row_shard() is None)


REDUCED = (torch.bfloat16, torch.float16)


def widen(x):
    """x in f32 when its dtype is a reduced one (its values exact there),
    else x itself (f32 and a float64 reference run keep their dtype)."""
    return x.float() if x.dtype in REDUCED else x


def reduced_dtype(dtype):
    """The compute dtype of a knob: None for float32 (the modules' own
    float32 path), else the dtype."""
    return None if dtype is None or dtype == torch.float32 else dtype


def conv_in(conv, x, dtype):
    """``conv`` (an nn.Conv2d) on ``x`` in ``dtype``, as flax's
    ``nn.Conv(dtype=...)``: input and weight cast to it, the product's output
    in it, then the bias cast to it and added (rounded again); the
    parameters stay f32. dtype None: the module's own call."""
    dtype = reduced_dtype(dtype)
    if dtype is None:
        return conv(x)
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y if conv.bias is None else y + conv.bias.to(dtype)[:, None, None]


def dense_in(lin, x, dtype):
    """``lin`` (an nn.Linear) on ``x`` in ``dtype``, as flax's
    ``nn.Dense(dtype=...)`` (the bias cast and added after the product)."""
    dtype = reduced_dtype(dtype)
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def leaky_relu(x):
    """LeakyReLU(0.01) in the input's dtype, with the slope rounded to it,
    as jax.nn.leaky_relu computes on a bf16 array."""
    return torch.where(x >= 0, x, x * x.new_tensor(LEAKY_SLOPE))


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class ResB(nn.Module):
    """Residual block: conv3 -> LeakyReLU(0.01) -> conv3 -> + identity
    (reference pasmnet/backbone.py:4-15). Where autograd records nothing
    for a float32 block (``takes_resb``) it runs as ``ops.conv3x3.resb``."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(channels, channels, dtype=dtype), LeakyReLU(),
            Conv(channels, channels, dtype=dtype),
        )

    def forward(self, x):
        c0, c1 = self.body[0], self.body[2]
        if takes_resb(x, c0, c1):
            return resb(x, c0.weight, c0.bias, c1.weight, c1.bias)
        return x + self.body(x)

    def forward_remat(self, x):
        """``forward`` under torch.utils.checkpoint: the backward recomputes
        the block instead of keeping its inner activation. The weights go in
        as explicit inputs, so the recompute uses this call's tensors
        (``torch.func.functional_call`` swaps them in only for the call), and
        so does the reduced convs' route: the recompute runs on autograd's
        thread, outside this call's context."""
        c0, c1 = self.body[0], self.body[2]
        route = current_reduced_route()

        def run(x, w0, b0, w1, b1):
            with reduced_conv_route(route):
                y = leaky_relu(conv(x, w0, b0, c0.padding, c0.compute_dtype))
                return x + conv(y, w1, b1, c1.padding, c1.compute_dtype)

        return checkpoint(run, x, c0.weight, c0.bias, c1.weight, c1.bias,
                          use_reentrant=False)
