"""Memory-bounded training-time parallax attention — port of
color_transfer_tpu/ops/parallax_train.py (no kernel: plain torch ops).

The materialised training step holds four (B, H, W, W) attention volumes,
att_r2l, att_l2r and both cycle products, because the PAM losses consume
them (reference pasmnet/utils.py:28-52, pasmnet/losses.py:10-46). This
computes the same outputs and loss values over chunks of image rows: each
chunk holds (B, chunk, W, W) tiles, reduces its loss terms to scalar sums,
and runs under ``torch.utils.checkpoint``, so the backward recomputes the
chunk's attention instead of keeping it. Attention memory drops from
O(B H W^2) to O(B chunk W^2).

The chunks couple in one place: the smoothness term's H-direction shift
(|att[:, h + 1] - att[:, h]|, reference pasmnet/losses.py:42) across a
chunk border, which takes the previous chunk's last attention row.
"""

import torch
from torch.utils.checkpoint import checkpoint

from color_transfer_tpu_torch.parallel.data_parallel import rank_mean


def _pick_chunk(h, wanted):
    """The largest divisor of ``h`` not above ``wanted``."""
    chunk = min(wanted, h)
    while h % chunk:
        chunk -= 1
    return chunk


def _chunk(ql, kl, qr, kr, vr, il, ir, prev_r2l, prev_l2r, scale):
    """One chunk of rows -> (warped_v, mask_l, mask_r, sums, last rows).
    ``sums`` stacks the chunk's photometric and cycle numerators, mask
    counts and smoothness sums; ``prev_*`` are the previous chunk's last
    attention rows (None for the first chunk)."""
    att_r2l = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", ql, kr) * scale, dim=-1)
    att_l2r = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", qr, kl) * scale, dim=-1)

    # Valid masks from the detached column sums (reference pasmnet/utils.py:34).
    mask_l = att_l2r.detach().sum(dim=-2) > 0.1  # (B, chunk, W)
    mask_r = att_r2l.detach().sum(dim=-2) > 0.1
    mask_l_f = mask_l.to(ql.dtype)[..., None]
    mask_r_f = mask_r.to(ql.dtype)[..., None]

    warped_v = torch.einsum("bhwv,bhvc->bhwc", att_r2l, vr)
    warp_ir = torch.einsum("bhwv,bhvc->bhwc", att_r2l, ir)
    warp_il = torch.einsum("bhwv,bhvc->bhwc", att_l2r, il)
    eye = torch.eye(ql.shape[2], dtype=ql.dtype, device=ql.device)
    cyc_l = torch.einsum("bhwv,bhvu->bhwu", att_r2l, att_l2r)
    cyc_r = torch.einsum("bhwv,bhvu->bhwu", att_l2r, att_r2l)

    def smoothness(att, prev_last):
        """H-shift sum (inside the chunk, and across its upper border) and
        the diagonal W-shift sum."""
        vertical = torch.abs(att[:, 1:] - att[:, :-1]).sum()
        if prev_last is not None:
            vertical = vertical + torch.abs(att[:, 0] - prev_last).sum()
        return vertical, torch.abs(att[:, :, :-1, :-1] - att[:, :, 1:, 1:]).sum()

    sm_h_a, sm_w_a = smoothness(att_r2l, prev_r2l)
    sm_h_b, sm_w_b = smoothness(att_l2r, prev_l2r)
    sums = torch.stack([
        (torch.abs(il - warp_ir) * mask_l_f).sum(),
        (torch.abs(ir - warp_il) * mask_r_f).sum(),
        mask_l_f.sum(),
        mask_r_f.sum(),
        (torch.abs(cyc_l - eye) * mask_l_f).sum(),
        (torch.abs(cyc_r - eye) * mask_r_f).sum(),
        sm_h_a + sm_h_b,
        sm_w_a + sm_w_b,
    ])
    # The last rows are copied: a view would keep the chunk's whole
    # attention alive until the backward.
    return warped_v, mask_l, mask_r, sums, att_r2l[:, -1].clone(), att_l2r[:, -1].clone()


def chunked_parallax_train(q_l, k_l, q_r, k_r, v_r, img_l, img_r, scale, chunk=8):
    """Training matcher: attention warp, valid masks and PAM losses.

    Args:
      q_l, k_l, q_r, k_r: (B, H, W, C) query and key features of each view.
      v_r: (B, H, W, Cv) value features of the right view.
      img_l, img_r: (B, H, W, 3) the target and reference images (the
        photometric loss's operands, reference pasmnet/losses.py:14-21).
      scale: the score scale (1/C in the reference, pasmnet/attention.py:41).
      chunk: rows a step (reduced to a divisor of H).

    Returns (warped_v (B, H, W, Cv) = att_r2l @ v_r, valid_mask_left,
    valid_mask_right (B, H, W, 1) bool, losses): ``losses`` holds the
    unweighted 'photometric', 'cycle' and 'smoothness' scalars (the caller
    applies the 0.005 factors, reference methods/dcmcs3di.py:75-77).
    """
    b, h, w, _ = q_l.shape
    chunk = _pick_chunk(h, chunk)
    warped, masks_l, masks_r = [], [], []
    total = None
    prev_r2l = prev_l2r = None
    for start in range(0, h, chunk):
        rows = slice(start, start + chunk)
        args = [x[:, rows] for x in (q_l, k_l, q_r, k_r, v_r, img_l, img_r)]
        warped_v, mask_l, mask_r, sums, prev_r2l, prev_l2r = checkpoint(
            _chunk, *args, prev_r2l, prev_l2r, scale, use_reentrant=False)
        warped.append(warped_v)
        masks_l.append(mask_l)
        masks_r.append(mask_r)
        total = sums if total is None else total + sums
    pm_l, pm_r, den_l, den_r, cyc_l, cyc_r, sm_h, sm_w = total
    # The masked means' counts over the ranks of a data-parallel step.
    den_l, den_r = rank_mean(den_l), rank_mean(den_r)
    losses = {
        "photometric": pm_l / den_l + pm_r / den_r,
        "cycle": cyc_l / den_l + cyc_r / den_r,
        # Means over the shifted tensors' true element counts (F.l1_loss,
        # reference pasmnet/losses.py:42-45).
        "smoothness": sm_h / (b * (h - 1) * w * w) + sm_w / (b * h * (w - 1) * (w - 1)),
    }
    return (torch.cat(warped, dim=1), torch.cat(masks_l, dim=1)[..., None],
            torch.cat(masks_r, dim=1)[..., None], losses)
