"""DCMCS3DI (Croci et al.) in plain float32 torch, the training forward on
the materialised parallax attention: a siamese extractor (a 3x3 conv and
18 residual blocks), the parallax attention block (a residual head, 1x1
Q/K/V, two (B, H, W, W) cost volumes, softmax, the cycle maps and the valid
masks), and the transfer net (a 1x1 conv, 6 residual blocks, two 3x3 convs)
on [features, warped reference features, valid mask]. The loss is L1 + MSE
+ SSIM loss + 0.005 x (photometric + cycle + smoothness) of the attention.
NHWC throughout; parameter names follow the reference Lightning module
(``extraction``, ``matcher``, ``transfer``)."""

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import ssim_loss


class Conv(nn.Conv2d):
    """'same' zero padding, stride 1, NHWC in and out."""

    def __init__(self, cin, cout, kernel_size=3):
        super().__init__(cin, cout, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                        padding=self.padding).permute(0, 2, 3, 1)


class LeakyReLU(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.01)


class ResB(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.body = nn.Sequential(Conv(c, c), LeakyReLU(), Conv(c, c))

    def forward(self, x):
        return x + self.body(x)


class PAB(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.channels = c
        self.head = ResB(c)
        self.query = Conv(c, c, 1)
        self.key = Conv(c, c, 1)
        self.value = Conv(c, c, 1)

    def forward(self, left, right):
        fea = self.head(torch.cat([left, right], dim=0))
        q_l, q_r = self.query(fea).chunk(2, dim=0)
        k_l, k_r = self.key(fea).chunk(2, dim=0)
        c = self.channels
        return (torch.einsum("bhwc,bhvc->bhwv", q_l, k_r) / c,
                torch.einsum("bhwc,bhvc->bhwv", q_r, k_l) / c)


def warp(image, att):
    return torch.einsum("bhwv,bhvc->bhwc", att, image)


class DCMCS3DI(nn.Module):
    def __init__(self, extraction_layers=18, transfer_layers=6, channels=64):
        super().__init__()
        c = channels
        self.extraction = nn.Sequential(Conv(3, c), *[ResB(c) for _ in range(extraction_layers)])
        self.matcher = PAB(c)
        self.transfer = nn.Sequential(Conv(2 * c + 1, c, 1), *[ResB(c) for _ in range(transfer_layers)],
                                      Conv(c, c // 2), Conv(c // 2, 3))

    def forward(self, left, right):
        """left = the distorted target view, right = the reference view ->
        (corrected, att, att_cycle, valid_mask)."""
        fea_l, fea_r = self.extraction(torch.cat([left, right], dim=0)).chunk(2, dim=0)
        cost_r2l, cost_l2r = self.matcher(fea_l, fea_r)
        att_r2l, att_l2r = torch.softmax(cost_r2l, dim=-1), torch.softmax(cost_l2r, dim=-1)
        mask_l = (att_l2r.detach().sum(dim=-2) > 0.1)[..., None]
        mask_r = (att_r2l.detach().sum(dim=-2) > 0.1)[..., None]
        cycle = (torch.einsum("bhwv,bhvu->bhwu", att_r2l, att_l2r),
                 torch.einsum("bhwv,bhvu->bhwu", att_l2r, att_r2l))
        warped = warp(self.matcher.value(fea_r), att_r2l)
        corrected = self.transfer(torch.cat([fea_l, warped, mask_l.to(fea_l.dtype)], dim=-1))
        return corrected.clamp(0.0, 1.0), (att_r2l, att_l2r), cycle, (mask_l, mask_r)


def _masked_l1(x, y, mask):
    mask = mask.to(x.dtype)
    return (torch.abs(x - y) * mask).sum() / mask.sum()


def _smooth(a):
    return (torch.abs(a[:, :-1] - a[:, 1:]).mean()
            + torch.abs(a[:, :, :-1, :-1] - a[:, :, 1:, 1:]).mean())


def loss(out, gt, target, reference):
    """The training objective on ``forward``'s output."""
    corrected, (att_r2l, att_l2r), (cyc_l, cyc_r), (mask_l, mask_r) = out
    eye = torch.eye(att_r2l.shape[-1], dtype=att_r2l.dtype, device=att_r2l.device)
    photometric = (_masked_l1(target, warp(reference, att_r2l), mask_l)
                   + _masked_l1(reference, warp(target, att_l2r), mask_r))
    cycle = _masked_l1(cyc_l, eye, mask_l) + _masked_l1(cyc_r, eye, mask_r)
    smooth = _smooth(att_r2l) + _smooth(att_l2r)
    return (torch.abs(corrected - gt).mean() + ((corrected - gt) ** 2).mean()
            + ssim_loss(corrected, gt) + 0.005 * (photometric + cycle + smooth))


# The training step's convolutions run on ATen: cuDNN's float32 algorithms
# put this model's gradients up to 1e-4 of their scale from float64.
CUDNN = False


def build(config):
    return DCMCS3DI(**config["sizes"])


def trainable(name):
    return True


def train_loss(model, batch, generator):
    del generator  # no random draw in the forward
    out = model(batch["target"], batch["reference"])
    return loss(out, batch["gt"], batch["target"], batch["reference"])
