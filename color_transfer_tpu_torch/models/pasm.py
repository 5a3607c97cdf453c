"""Parallax attention (PASM) — the matcher inside DCMCS3DI.

Port of color_transfer_tpu/models/pasm.py: ``PAB``, ``output`` (both
branches), ``warp``, the disparity regression and the PAM losses
(reference pasmnet/attention.py, utils.py, losses.py). NHWC throughout; the
cost volumes are (B, H, W, W) row-wise cross-view attention. Training
consumes the full attention tensors (the cycle and smoothness losses);
``ops/parallax_train.py`` computes the same losses in row chunks.
"""

import torch
from torch import nn

from color_transfer_tpu_torch.models.layers import Conv, ResB
from color_transfer_tpu_torch.parallel.data_parallel import rank_mean


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


def output(costs, inference=False, valid_w=None):
    """Softmax over the cost volumes -> attention maps, cycle maps and valid
    masks (reference pasmnet/utils.py:8-52).

    Returns ((att_r2l, att_l2r), (cycle_l, cycle_r), (mask_l, mask_r)); at
    inference the cycle maps and the right mask are None. The masks are
    (B, H, W, 1) bool: a column is matched when the detached attention
    refers to it with a total weight above 0.1.

    ``valid_w``: the true width under bucketed evaluation. Padded query
    positions (index >= valid_w) still softmax to unit mass; they are left
    out of the column sums.
    """
    cost_right2left, cost_left2right = costs
    att_right2left = torch.softmax(cost_right2left, dim=-1)
    att_left2right = torch.softmax(cost_left2right, dim=-1)

    def colsum(att):
        att = att.detach()
        if valid_w is not None:
            w = att.shape[2]
            keep = torch.arange(w, device=att.device) < valid_w
            att = att * keep.to(att.dtype)[:, None]
        return att.sum(dim=-2)

    valid_mask_left = (colsum(att_left2right) > 0.1)[..., None]
    if inference:
        return (att_right2left, att_left2right), (None, None), (valid_mask_left, None)

    valid_mask_right = (colsum(att_right2left) > 0.1)[..., None]
    att_left2right2left = torch.einsum("bhwv,bhvu->bhwu", att_right2left, att_left2right)
    att_right2left2right = torch.einsum("bhwv,bhvu->bhwu", att_left2right, att_right2left)
    return (
        (att_right2left, att_left2right),
        (att_left2right2left, att_right2left2right),
        (valid_mask_left, valid_mask_right),
    )


def warp(image, att):
    """Apply a matching attention map: (B,H,W,W) @ (B,H,W,C) -> (B,H,W,C)
    (reference pasmnet/utils.py:108-127, without the NCHW permutes)."""
    return torch.einsum("bhwv,bhvc->bhwc", att, image)


def _shift_l(x):
    """The value at w + 1, zero past the edge (a [0, 1, 1] tap)."""
    return torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], dim=2)


def _shift_r(x):
    return torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]], dim=2)


def _inpaint(disp, mask, taps):
    """Partial-convolution sweeps along the width with the given neighbour
    taps until the valid mask stops growing (each sweep that grows extends
    it by at least a pixel, so at most W sweeps)."""
    while True:
        neigh_mask, neigh_disp = mask, disp
        for tap in taps:
            neigh_mask = neigh_mask + tap(mask)
            neigh_disp = neigh_disp + tap(disp)
        new_valid = (neigh_mask > 0).to(disp.dtype)
        filled = neigh_disp / (neigh_mask + 1e-4)
        disp_next = disp * mask + filled * (new_valid - mask)
        grew = float(new_valid.sum() - mask.sum())
        disp, mask = disp_next, new_valid
        if grew <= 0:
            return disp, mask


def regress_disp(att, valid_mask):
    """Expected disparity with occlusion in-painting (reference
    pasmnet/utils.py:55-105); visualisation only.

    att: (B, H, W, W); valid_mask: (B, H, W, 1) float. Returns (B, H, W, 1).
    The in-painting runs two passes of partial convolutions: the reference's
    filter [1, 1, 0] (left and self) until the mask saturates, then [0, 1, 1]
    (self and right).
    """
    w = att.shape[-1]
    index = torch.arange(w, dtype=att.dtype, device=att.device)
    disp_ini = (index - torch.einsum("bhwv,v->bhw", att, index))[..., None]
    disp1, mask1 = _inpaint(disp_ini * valid_mask, valid_mask, [_shift_r])
    disp2, _ = _inpaint(disp1, mask1, [_shift_l])
    return disp_ini * valid_mask + disp2 * (1.0 - valid_mask)


# --- PAM losses (reference pasmnet/losses.py) ---


def masked_l1(x, y, mask):
    """Mean |x - y| over the mask; in a data-parallel train step divided by
    the ranks' mean mask count (parallel/data_parallel.py::rank_mean), so
    the ranks' mean is the global batch's masked mean."""
    mask = mask.to(x.dtype)
    return (torch.abs(x - y) * mask).sum() / rank_mean(mask.sum())


def loss_pam_photometric(img_left, img_right, att, valid_mask):
    att_right2left, att_left2right = att
    valid_mask_left, valid_mask_right = valid_mask
    return (masked_l1(img_left, warp(img_right, att_right2left), valid_mask_left)
            + masked_l1(img_right, warp(img_left, att_left2right), valid_mask_right))


def loss_pam_cycle(att_cycle, valid_mask):
    att_l2r2l, att_r2l2r = att_cycle
    valid_mask_left, valid_mask_right = valid_mask
    w = att_l2r2l.shape[-1]
    eye = torch.eye(w, dtype=att_l2r2l.dtype, device=att_l2r2l.device)
    # The (B, H, W, 1) mask broadcasts over the last attention axis (the
    # reference's permute(0, 2, 3, 1), pasmnet/losses.py:32-33).
    return (masked_l1(att_l2r2l, eye, valid_mask_left)
            + masked_l1(att_r2l2r, eye, valid_mask_right))


def loss_pam_smoothness(att):
    def smooth(a):
        return (torch.abs(a[:, :-1] - a[:, 1:]).mean()
                + torch.abs(a[:, :, :-1, :-1] - a[:, :, 1:, 1:]).mean())

    att_r2l, att_l2r = att
    return smooth(att_r2l) + smooth(att_l2r)
