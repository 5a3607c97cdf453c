"""DCMCS3DI served: the published inference forward of Croci et al.'s
network (the reference repo's ``methods/dcmcs3di.py`` at inference, its
``pasmnet`` parallax attention) in plain float32 torch, on the model and
weights of ``reference/dcmcs3di.py``.

    fea_l, fea_r = extraction(target), extraction(reference)
    att_r2l = softmax(q_l k_r^T / C), att_l2r = softmax(q_r k_l^T / C)
    mask_l  = colsum(att_l2r) > 0.1
    corrected = clamp(transfer([fea_l, att_r2l value(fea_r), mask_l]), 0, 1)

The attention is computed in bands of image rows, each direction's
(B, rows, W, W) volume in turn, so that none holds more than ``BAND_BYTES``
(the whole 1080p volumes would take ~30 GB each, the reference repo's
forward ~95 GB at once). Every row's attention depends on that row alone,
so the bands give the whole-volume forward's numbers: no departure from the
reference repo in the mathematics. Departures in form only: NHWC tensors
(the reference repo's NCHW permutes left out), the cycle maps and the right
view's mask, which inference does not use, not formed."""

import torch

from benchmark.reference.dcmcs3di import CUDNN, build, train_loss, trainable, warp  # noqa: F401

BAND_BYTES = 1 << 30  # one direction's float32 attention volume of a band, at most


def band_rows(b, w):
    """Image rows a band of a (b, rows, w, w) float32 volume under BAND_BYTES."""
    return max(1, BAND_BYTES // (4 * b * w * w))


def serve(model, target, reference, band=None):
    """(target, reference) (B, H, W, 3) in [0, 1] -> (the corrected target,
    {}): no output beside the corrected frame. ``band``: image rows an
    attention band (default ``band_rows``)."""
    fea_l, fea_r = model.extraction(torch.cat([target, reference], dim=0)).chunk(2, dim=0)
    m = model.matcher
    fea = m.head(torch.cat([fea_l, fea_r], dim=0))
    q_l, q_r = m.query(fea).chunk(2, dim=0)
    k_l, k_r = m.key(fea).chunk(2, dim=0)
    v_r = m.value(fea_r)
    b, h, w, c = q_l.shape
    band = band or band_rows(b, w)
    warped, mask_l = [], []
    for h0 in range(0, h, band):
        rows = slice(h0, h0 + band)
        att_r2l = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", q_l[:, rows], k_r[:, rows]) / c,
                                dim=-1)
        warped.append(warp(v_r[:, rows], att_r2l))
        del att_r2l
        att_l2r = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", q_r[:, rows], k_l[:, rows]) / c,
                                dim=-1)
        mask_l.append(att_l2r.sum(dim=-2) > 0.1)
        del att_l2r
    warped, mask_l = torch.cat(warped, dim=1), torch.cat(mask_l, dim=1)[..., None]
    corrected = model.transfer(torch.cat([fea_l, warped, mask_l.to(fea_l.dtype)], dim=-1))
    return corrected.clamp(0.0, 1.0), {}
