"""Parallax attention (PASM) — the matcher inside DCMCS3DI, inference half.

Port of color_transfer_tpu/models/pasm.py: ``PAB`` and, on their inference
branch, ``output`` and ``warp``. NHWC throughout; the cost volumes are
(B, H, W, W) row-wise cross-view attention. The disparity regression and
the PAM losses (visualisation and training) are not ported yet.
"""

import torch
from torch import nn

from color_transfer_tpu_torch.models.layers import Conv, ResB


class PAB(nn.Module):
    """Parallax attention block: shared ResB head + 1x1 Q/K/V convs building
    two (B, H, W, W) cost volumes (reference pasmnet/attention.py:9-48).
    Always float32."""

    def __init__(self, channels):
        super().__init__()
        self.channels = channels
        self.head = ResB(channels)
        self.query = Conv(channels, channels, kernel_size=1)
        self.key = Conv(channels, channels, kernel_size=1)
        self.value = Conv(channels, channels, kernel_size=1)

    def forward(self, x_left, x_right):
        c = self.channels
        # Both views ride one batch-concatenated pass (shared weights).
        fea = self.head(torch.cat([x_left, x_right], dim=0))
        q_l, q_r = self.query(fea).chunk(2, dim=0)
        k_l, k_r = self.key(fea).chunk(2, dim=0)
        cost_right2left = torch.einsum("bhwc,bhvc->bhwv", q_l, k_r) / c
        cost_left2right = torch.einsum("bhwc,bhvc->bhwv", q_r, k_l) / c
        return cost_right2left, cost_left2right

    def value_features(self, x):
        return self.value(x)


def output(costs, inference=True):
    """Softmax over the cost volumes -> attention maps and the left valid
    mask (reference pasmnet/utils.py:8-52), inference branch: returns
    ((att_r2l, att_l2r), (None, None), (mask_l, None)) with mask_l
    (B, H, W, 1) bool, colsum(att_l2r) > 0.1."""
    if not inference:
        raise NotImplementedError(
            "pasm.output(inference=False): the cycle maps and the right mask "
            "serve training, which is not ported yet"
        )
    cost_right2left, cost_left2right = costs
    att_right2left = torch.softmax(cost_right2left, dim=-1)
    att_left2right = torch.softmax(cost_left2right, dim=-1)
    valid_mask_left = (att_left2right.sum(dim=-2) > 0.1)[..., None]
    return (att_right2left, att_left2right), (None, None), (valid_mask_left, None)


def warp(image, att):
    """Apply a matching attention map: (B,H,W,W) @ (B,H,W,C) -> (B,H,W,C)
    (reference pasmnet/utils.py:108-127, without the NCHW permutes)."""
    return torch.einsum("bhwv,bhvc->bhwc", att, image)
