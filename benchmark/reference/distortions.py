"""The training targets: each gt image distorted by six photometric ops
(brightness, contrast, saturation, hue, gamma, sharpness) in a random order
at random magnitudes, torchvision's semantics on channel-last [0, 1]
images. The draws come from a CPU generator, per image in batch order: a
permutation of the six ops, then six factors ~ U(0.5, 1.5)."""

import torch

from benchmark.reference.ops import filter3x3


def _blend(a, b, ratio):
    return torch.clamp(ratio * a + (1.0 - ratio) * b, 0.0, 1.0)


def _gray(img):
    return img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    cr = maxc - torch.minimum(torch.minimum(r, g), b)
    ones = torch.ones_like(maxc)
    s = cr / torch.where(maxc == 0, ones, maxc)
    crd = torch.where(cr == 0, ones, cr)
    rc, gc, bc = (maxc - r) / crd, (maxc - g) / crd, (maxc - b) / crd
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(cr == 0, torch.zeros_like(h), h)
    return torch.stack([(h / 6.0) % 1.0, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _hue(img, shift):
    h, s, v = _rgb_to_hsv(img).unbind(-1)
    return _hsv_to_rgb(torch.stack([(h + shift) % 1.0, s, v], dim=-1))


def _sharpness(img, factor):
    """Blend with a fixed 3x3 blur whose 1-pixel border keeps the input."""
    h, w = img.shape[-3], img.shape[-2]
    x = torch.movedim(img, -1, -3)
    kernel = (torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                           dtype=torch.float64) / 13.0).to(img.dtype).tolist()
    blurred = filter3x3(x, kernel)
    interior = torch.zeros(h, w, dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    blurred = torch.where(interior, torch.clamp(blurred, 0.0, 1.0), x)
    return torch.movedim(_blend(x, blurred, factor), -3, -1)


def distort(img, perm, factors):
    f = [float(v) for v in factors]
    ops = (
        lambda im: _blend(im, torch.zeros_like(im), f[0]),
        lambda im: _blend(im, _gray(im).mean(dim=(-2, -1), keepdim=True)[..., None].expand(im.shape),
                          f[1]),
        lambda im: _blend(im, _gray(im)[..., None].expand(im.shape), f[2]),
        lambda im: _hue(im, f[3] - 1.0),
        lambda im: torch.clamp(torch.clamp_min(im, 0.0) ** f[4], 0.0, 1.0),
        lambda im: _sharpness(im, f[5]),
    )
    for i in perm:
        img = ops[int(i)](img)
    return img


def distort_batch(gt, seed):
    """Every image of the (B, H, W, 3) batch distorted, the draws from a CPU
    generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    draws = []
    for _ in range(gt.shape[0]):
        perm = torch.randperm(6, generator=g)
        draws.append((perm, 0.5 + torch.rand(6, generator=g)))
    return torch.stack([distort(img, perm, factors) for img, (perm, factors) in zip(gt, draws)])
