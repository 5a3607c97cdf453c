"""Shared building blocks of DCMCS3DI: Conv and ResB.

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
        x = x.permute(0, 3, 1, 2)
        if self.compute_dtype in (None, torch.float32):
            return F.conv2d(x.float(), self.weight, self.bias,
                            padding=self.padding).permute(0, 2, 3, 1)
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), self.weight.to(cd), None, padding=self.padding)
        return (y + self.bias.to(cd)[:, None, None]).permute(0, 2, 3, 1)


def leaky_relu(x):
    """LeakyReLU(0.01) in the input's dtype, with the slope rounded to it,
    as jax.nn.leaky_relu computes on a bf16 array."""
    return torch.where(x >= 0, x, x * x.new_tensor(0.01))


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky_relu(x)


class ResB(nn.Module):
    """Residual block: conv3 -> LeakyReLU(0.01) -> conv3 -> + identity
    (reference pasmnet/backbone.py:4-15)."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        self.body = nn.Sequential(
            Conv(channels, channels, dtype=dtype), LeakyReLU(),
            Conv(channels, channels, dtype=dtype),
        )

    def forward(self, x):
        return x + self.body(x)
