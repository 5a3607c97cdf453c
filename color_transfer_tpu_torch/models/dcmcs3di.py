"""DCMCS3DI — Deep Color Mismatch Correction in Stereoscopic 3D Images,
inference.

Port of color_transfer_tpu/models/dcmcs3di.py: siamese ResB extractor ->
parallax attention matcher -> transfer net. NHWC throughout; submodule
names (``extraction``, ``matcher``, ``transfer``) follow the reference
Lightning module, so the state_dict is the layout color_transfer_tpu's
``convert_dcmcs3di`` reads.

``compute_dtype`` (None or bfloat16) is the mixed-precision recipe: the
extraction and transfer convs run in it, while the matcher (head, Q/K/V
projections, softmax statistics) stays float32.

Two inference routes, as in the JAX package:
  * the materialised matcher (two (B, H, W, W) cost volumes, ``pasm``);
  * ``use_kernels=True`` (JAX's ``use_pallas``): the row-attention kernel
    B5 (ops/row_attention.py), no (B, H, W, W) tensor; with
    ``fused_extraction`` the ResB stacks go through the conv-chain kernel
    B6 (ops/conv_chain.py). None means auto: on for the kernel route under
    bf16.
A CPU tensor takes each kernel's plain torch version.
"""

import torch
from torch import nn

from color_transfer_tpu_torch.models import pasm
from color_transfer_tpu_torch.models.layers import Conv, ResB
from color_transfer_tpu_torch.ops.conv_chain import resb_chain
from color_transfer_tpu_torch.ops.row_attention import fused_parallax_inference


def _chain_params(blocks):
    """Stacked ResB weights in the JAX package's layout: kernels
    (L, 2, 3, 3, C, C) HWIO and biases (L, 2, C)."""
    convs = [(blk.body[0], blk.body[2]) for blk in blocks]
    kernels = torch.stack([
        torch.stack([c.weight.permute(2, 3, 1, 0) for c in pair]) for pair in convs
    ])
    biases = torch.stack([torch.stack([c.bias for c in pair]) for pair in convs])
    return kernels, biases


class Extractor(nn.Sequential):
    """Conv(3->C) + N ResB (reference methods/dcmcs3di.py:41-43)."""

    def __init__(self, channels=64, layers=18, dtype=None):
        super().__init__(
            Conv(3, channels, dtype=dtype),
            *[ResB(channels, dtype=dtype) for _ in range(layers)],
        )
        self.compute_dtype = dtype or torch.float32

    def fused(self, x):
        """Extraction with the ResB stack through the conv-chain kernel:
        the stem conv as ``forward`` runs it, then ``resb_chain``. Returns
        float32 features."""
        kernels, biases = _chain_params(list(self)[1:])
        return resb_chain(self[0](x), kernels, biases, self.compute_dtype)


class TransferNet(nn.Sequential):
    """Conv1x1(2C+1 -> C) + N ResB + Conv(C->C/2) + Conv(C/2->3)
    (reference methods/dcmcs3di.py:47-51)."""

    def __init__(self, channels=64, layers=6, dtype=None):
        super().__init__(
            Conv(2 * channels + 1, channels, kernel_size=1, dtype=dtype),
            *[ResB(channels, dtype=dtype) for _ in range(layers)],
            Conv(channels, channels // 2, dtype=dtype),
            Conv(channels // 2, 3, dtype=dtype),
        )
        self.compute_dtype = dtype or torch.float32

    def fused(self, x):
        """The 1x1 stem and the two tail convs as ``forward`` runs them, the
        ResB stack through the conv-chain kernel (see Extractor.fused)."""
        kernels, biases = _chain_params(list(self)[1:-2])
        y = resb_chain(self[0](x), kernels, biases, self.compute_dtype)
        return self[-1](self[-2](y))


class DCMCS3DI(nn.Module):
    def __init__(self, extraction_layers=18, transfer_layers=6, channels=64,
                 compute_dtype=None):
        super().__init__()
        self.channels = channels
        self.compute_dtype = compute_dtype
        self.extraction = Extractor(channels, extraction_layers, dtype=compute_dtype)
        self.matcher = pasm.PAB(channels)
        self.transfer = TransferNet(channels, transfer_layers, dtype=compute_dtype)

    def _extract(self, left, right):
        """Siamese extraction; features return to float32 at the matcher
        boundary."""
        fea = self.extraction(torch.cat([left, right], dim=0))
        return fea.float().chunk(2, dim=0)

    def forward(self, left, right, inference=False, use_kernels=False,
                precise=False, fused_extraction=None):
        """left = distorted target view, right = reference view; NHWC [0, 1].

        Returns (corrected_left, aux) with aux = (att, att_cycle, valid_mask,
        warped_right) as the JAX model returns at inference; on the kernel
        route aux is ((None, None), (None, None), (mask_l, None), None).
        ``precise`` keeps the row-attention operands float32.
        """
        if not inference:
            raise NotImplementedError(
                "DCMCS3DI training forward (inference=False) is not ported yet"
            )
        if fused_extraction is None:
            fused_extraction = use_kernels and self.compute_dtype == torch.bfloat16
        if fused_extraction:
            fea_left, fea_right = self.extraction.fused(
                torch.cat([left, right], dim=0)).chunk(2, dim=0)
        else:
            fea_left, fea_right = self._extract(left, right)
        transfer = self.transfer.fused if fused_extraction else self.transfer

        if use_kernels:
            m = self.matcher
            head = m.head(torch.cat([fea_left, fea_right], dim=0))
            q_l, q_r = m.query(head).chunk(2, dim=0)
            k_l, k_r = m.key(head).chunk(2, dim=0)
            warped, valid_mask_left = fused_parallax_inference(
                q_l, k_r, m.value(fea_right), q_r, k_l,
                scale=1.0 / self.channels, precise=precise,
            )
            cat = torch.cat([fea_left, warped, valid_mask_left.float()], dim=-1)
            corrected = transfer(cat)
            return corrected.float().clamp(0.0, 1.0), (
                (None, None), (None, None), (valid_mask_left, None), None,
            )

        att, att_cycle, valid_mask = pasm.output(
            self.matcher(fea_left, fea_right), inference=True
        )
        fea_warped_right = pasm.warp(self.matcher.value_features(fea_right), att[0])
        cat = torch.cat([fea_left, fea_warped_right, valid_mask[0].float()], dim=-1)
        corrected = transfer(cat)
        return corrected.float().clamp(0.0, 1.0), (
            att, att_cycle, valid_mask, pasm.warp(right, att[0]),
        )
