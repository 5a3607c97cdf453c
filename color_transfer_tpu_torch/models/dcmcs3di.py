"""DCMCS3DI — Deep Color Mismatch Correction in Stereoscopic 3D Images.

Port of color_transfer_tpu/models/dcmcs3di.py: siamese ResB extractor ->
parallax attention matcher -> transfer net, trained with L1 + MSE + SSIM
plus the 0.005-weighted PAM losses (photometric, cycle, smoothness). NHWC
throughout; submodule names (``extraction``, ``matcher``, ``transfer``)
follow the reference Lightning module, so the state_dict is the layout
color_transfer_tpu's ``convert_dcmcs3di`` reads.

``compute_dtype`` (None or bfloat16) is the mixed-precision recipe: the
extraction and transfer convs run in it, while the matcher (head, Q/K/V
projections, softmax statistics) stays float32. ``remat_convs`` runs each
ResB block of the two stacks under ``torch.utils.checkpoint`` when autograd
records (one more forward in the backward, the blocks' inner activations
not kept); the state_dict and the values are the same either way.

Inference routes, as in the JAX package:
  * the materialised matcher (two (B, H, W, W) cost volumes, ``pasm``);
  * ``use_kernels=True`` (JAX's ``use_pallas``): the row-attention kernel
    B5 (ops/row_attention.py), no (B, H, W, W) tensor; with
    ``fused_extraction`` the ResB stacks go through the conv-chain kernel
    B6 (ops/conv_chain.py). None means auto: on for the kernel route under
    bf16.
On either route the matcher (the head, Q/K/V and the attention) runs in the
span ``dcmcs3di.attention`` and the transfer net in ``dcmcs3di.transfer``,
beside the extractor's ``dcmcs3di.extraction``.
A CPU tensor takes each kernel's plain torch version. Training runs the
materialised matcher (``inference=False``) or the chunked one
(``fused_train_forward``, ops/parallax_train.py).
"""

import torch
from torch import nn

from color_transfer_tpu_torch import metrics
from color_transfer_tpu_torch.models import pasm
from color_transfer_tpu_torch.models.layers import Conv, ResB
from color_transfer_tpu_torch.ops.conv_chain import resb_chain
from color_transfer_tpu_torch.ops.parallax_train import chunked_parallax_train
from color_transfer_tpu_torch.ops.row_attention import fused_parallax_inference
from color_transfer_tpu_torch.utils import profiling


def _chain_params(blocks):
    """Stacked ResB weights in the JAX package's layout: kernels
    (L, 2, 3, 3, C, C) HWIO and biases (L, 2, C)."""
    convs = [(blk.body[0], blk.body[2]) for blk in blocks]
    kernels = torch.stack([
        torch.stack([c.weight.permute(2, 3, 1, 0) for c in pair]) for pair in convs
    ])
    biases = torch.stack([torch.stack([c.bias for c in pair]) for pair in convs])
    return kernels, biases


def _blocks(blocks, x, remat):
    """Run ResB ``blocks`` in order, each rematerialised when ``remat`` and
    autograd records."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        x = blk.forward_remat(x) if remat else blk(x)
    return x


class Extractor(nn.Sequential):
    """Conv(3->C) + N ResB (reference methods/dcmcs3di.py:41-43)."""

    def __init__(self, channels=64, layers=18, dtype=None, remat=False):
        super().__init__(
            Conv(3, channels, dtype=dtype),
            *[ResB(channels, dtype=dtype) for _ in range(layers)],
        )
        self.compute_dtype = dtype or torch.float32
        self.remat = remat

    def forward(self, x):
        # The stem's output as a contiguous NHWC tensor: on ATen's route
        # (f32 training, cuDNN off) it comes back NCHW in memory, and the
        # residual stream would carry that layout through all 18 blocks and
        # the matcher head, into every residual add and every conv3x3 call
        # (a copy a call). Early in the forward, the copy leaves the step's
        # peak memory as it is (the transfer net's entry, late, would not).
        return _blocks(list(self)[1:], self[0](x).contiguous(), self.remat)

    def fused(self, x):
        """Extraction with the ResB stack through the conv-chain kernel:
        the stem conv as ``forward`` runs it, then ``resb_chain``. Returns
        float32 features."""
        kernels, biases = _chain_params(list(self)[1:])
        return resb_chain(self[0](x), kernels, biases, self.compute_dtype)


class TransferNet(nn.Sequential):
    """Conv1x1(2C+1 -> C) + N ResB + Conv(C->C/2) + Conv(C/2->3)
    (reference methods/dcmcs3di.py:47-51)."""

    def __init__(self, channels=64, layers=6, dtype=None, remat=False):
        super().__init__(
            Conv(2 * channels + 1, channels, kernel_size=1, dtype=dtype),
            *[ResB(channels, dtype=dtype) for _ in range(layers)],
            Conv(channels, channels // 2, dtype=dtype),
            Conv(channels // 2, 3, dtype=dtype),
        )
        self.compute_dtype = dtype or torch.float32
        self.remat = remat

    def forward(self, x):
        y = _blocks(list(self)[1:-2], self[0](x), self.remat)
        return self[-1](self[-2](y))

    def fused(self, x):
        """The 1x1 stem and the two tail convs as ``forward`` runs them, the
        ResB stack through the conv-chain kernel (see Extractor.fused)."""
        kernels, biases = _chain_params(list(self)[1:-2])
        y = resb_chain(self[0](x), kernels, biases, self.compute_dtype)
        return self[-1](self[-2](y))


class DCMCS3DI(nn.Module):
    def __init__(self, extraction_layers=18, transfer_layers=6, channels=64,
                 compute_dtype=None, remat_convs=False):
        super().__init__()
        self.channels = channels
        self.compute_dtype = compute_dtype
        self.extraction = Extractor(channels, extraction_layers, dtype=compute_dtype,
                                    remat=remat_convs)
        self.matcher = pasm.PAB(channels)
        self.transfer = TransferNet(channels, transfer_layers, dtype=compute_dtype,
                                    remat=remat_convs)

    def _dtype(self):
        """The matcher's dtype, which features and outputs return to: float32
        (float64 in a reference run on float64 weights)."""
        return self.matcher.query.weight.dtype

    def _extract(self, left, right):
        """Siamese extraction; features return to the matcher's dtype at its
        boundary."""
        with profiling.annotate("dcmcs3di.extraction"):
            fea = self.extraction(torch.cat([left, right], dim=0))
        return fea.to(self._dtype()).chunk(2, dim=0)

    def forward(self, left, right, inference=False, use_kernels=False,
                precise=False, fused_extraction=None, valid_w=None, chunk=None):
        """left = distorted target view, right = reference view; NHWC [0, 1].

        Returns (corrected_left, aux) with aux = (att, att_cycle, valid_mask,
        warped_right), the reference forward's (methods/dcmcs3di.py:53-66);
        at inference the cycle maps and the right mask are None, and on the
        kernel route aux is ((None, None), (None, None), (mask_l, None),
        None). ``precise`` keeps the row-attention operands float32.

        ``valid_w`` (bucketed evaluation, materialised route): cost columns
        at or beyond it are set to -1e30, so zero-padded width receives no
        attention. ``chunk`` (training): the call is ``fused_train_forward``
        with that many rows a step; it returns (corrected_left, pam_losses).
        """
        if chunk is not None:
            return self.fused_train_forward(left, right, chunk)
        if fused_extraction is None:
            fused_extraction = (inference and use_kernels
                                and self.compute_dtype == torch.bfloat16)
        if inference and fused_extraction:
            with profiling.annotate("dcmcs3di.extraction"):
                fea_left, fea_right = self.extraction.fused(
                    torch.cat([left, right], dim=0)).chunk(2, dim=0)
        else:
            fea_left, fea_right = self._extract(left, right)
        transfer = self.transfer.fused if inference and fused_extraction else self.transfer

        if inference and use_kernels:
            m = self.matcher
            with profiling.annotate("dcmcs3di.attention"):
                head = m.head(torch.cat([fea_left, fea_right], dim=0))
                q_l, q_r = m.query(head).chunk(2, dim=0)
                k_l, k_r = m.key(head).chunk(2, dim=0)
                warped, valid_mask_left = fused_parallax_inference(
                    q_l, k_r, m.value(fea_right), q_r, k_l,
                    scale=1.0 / self.channels, precise=precise,
                )
            with profiling.annotate("dcmcs3di.transfer"):
                cat = torch.cat([fea_left, warped, valid_mask_left.float()], dim=-1)
                corrected = transfer(cat)
            return corrected.float().clamp(0.0, 1.0), (
                (None, None), (None, None), (valid_mask_left, None), None,
            )

        with profiling.annotate("dcmcs3di.attention"):
            costs = self.matcher(fea_left, fea_right)
            if valid_w is not None:
                col = torch.arange(costs[0].shape[-1], device=left.device)
                costs = tuple(torch.where(col < valid_w, c, -1e30) for c in costs)
            att, att_cycle, valid_mask = pasm.output(costs, inference, valid_w=valid_w)
            fea_warped_right = pasm.warp(self.matcher.value_features(fea_right), att[0])
        with profiling.annotate("dcmcs3di.transfer"):
            cat = torch.cat([fea_left, fea_warped_right, valid_mask[0].to(fea_left.dtype)],
                            dim=-1)
            corrected = transfer(cat)
        return corrected.to(fea_left.dtype).clamp(0.0, 1.0), (
            att, att_cycle, valid_mask, pasm.warp(right, att[0]),
        )

    def fused_train_forward(self, left, right, chunk=8):
        """Training forward through the chunked matcher
        (ops/parallax_train.py): the corrected output and PAM loss values of
        ``forward`` + ``compute_losses`` without a (B, H, W, W) tensor.
        Returns (corrected_left, pam_losses), the losses unweighted."""
        fea_left, fea_right = self._extract(left, right)
        m = self.matcher
        head = m.head(torch.cat([fea_left, fea_right], dim=0))
        q_l, q_r = m.query(head).chunk(2, dim=0)
        k_l, k_r = m.key(head).chunk(2, dim=0)
        v_r = m.value(fea_right)
        with profiling.annotate("dcmcs3di.matcher"):
            warped_v, mask_l, _, pam = chunked_parallax_train(
                q_l, k_l, q_r, k_r, v_r, left, right, scale=1.0 / self.channels, chunk=chunk)
        corrected = self.transfer(
            torch.cat([fea_left, warped_v, mask_l.to(fea_left.dtype)], dim=-1))
        return corrected.to(fea_left.dtype).clamp(0.0, 1.0), pam


def _image_losses(corrected_left, gt):
    return {
        "L1 Loss": torch.abs(corrected_left - gt).mean(),
        "MSE Loss": ((corrected_left - gt) ** 2).mean(),
        "SSIM Loss": metrics.ssim_loss(corrected_left, gt, window_size=11),
    }


def _total(parts):
    return (parts["L1 Loss"] + parts["MSE Loss"] + parts["SSIM Loss"]
            + parts["Photometric Loss"] + parts["Cycle Loss"] + parts["Smoothness Loss"])


def compute_losses(model_out, batch):
    """The reference's training objective (methods/dcmcs3di.py:68-92) on the
    materialised forward's output -> (total, {name: scalar}). ``batch``
    holds NHWC 'gt', 'target' and 'reference'."""
    corrected_left, (att, att_cycle, valid_mask, _) = model_out
    parts = _image_losses(corrected_left, batch["gt"])
    parts["Photometric Loss"] = 0.005 * pasm.loss_pam_photometric(
        batch["target"], batch["reference"], att, valid_mask)
    parts["Cycle Loss"] = 0.005 * pasm.loss_pam_cycle(att_cycle, valid_mask)
    parts["Smoothness Loss"] = 0.005 * pasm.loss_pam_smoothness(att)
    return _total(parts), parts


def compute_losses_fused(corrected_left, pam_losses, batch):
    """The same objective on ``fused_train_forward``'s output, the PAM terms
    already reduced by the chunked matcher."""
    parts = _image_losses(corrected_left, batch["gt"])
    parts["Photometric Loss"] = 0.005 * pam_losses["photometric"]
    parts["Cycle Loss"] = 0.005 * pam_losses["cycle"]
    parts["Smoothness Loss"] = 0.005 * pam_losses["smoothness"]
    return _total(parts), parts
