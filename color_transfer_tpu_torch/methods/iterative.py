"""Iterative distribution transfer and automated colour grading (Pitie et al.
2007) — port of color_transfer_tpu/methods/iterative.py.

IDT: for each of ``n_iter`` random rotations, project target and reference
onto the rotated axes, match each axis's histogram CDF (255 uniform bins
over the joint range) and move the target by the difference, de-rotated.
Grading: IDT, then the regrain pyramid, which restores the target's
gradients around the IDT colours with damped-Jacobi sweeps per level.

Each method has a per-image form on (H, W, 3) tensors and a batched form
(``fn.batched``) on (F, H, W, 3) chunks, equal to the per-image form frame
by frame; a reference chunk of one frame serves every frame. On CUDA
tensors the transport apply runs kernel B3 (``ops/idt_apply.py``), once
per rotation per chunk, and each pyramid level's sweeps run kernel B4
(``ops/regrain_stencil.py``), once per level per chunk.

Rotations: the JAX package draws them from ``jax.random`` (PRNGKey(42) by
default), a stream torch cannot reproduce. ``random_rotations`` builds
them the same way from a ``torch.Generator``; every method also takes the
rotations as an argument, which is how the tests hand both packages the
same ones.
"""

import numpy as np
import torch

from color_transfer_tpu_torch.core.precision import full_f32_inference
from color_transfer_tpu_torch.core.resize import resize_antialias, resize_bilinear
from color_transfer_tpu_torch.methods.linear import per_image
from color_transfer_tpu_torch.ops.idt_apply import MAX_BINS, transport_apply
from color_transfer_tpu_torch.ops.regrain_stencil import (
    regrain_sweeps,
    shift_down,
    shift_left,
    shift_right,
    shift_up,
)

DEFAULT_SEED = 42  # the JAX package's PRNGKey(42)
NBITS = (4, 16, 32, 64, 64, 64)  # sweeps per pyramid level, finest first


def _uniform_histograms(scaled, bins):
    """Batched np.histogram with uniform bins: ``scaled`` (..., N) already in
    bin space ([0, bins)) -> (..., bins) float32 counts. Samples outside
    fall into the edge bins, as the JAX package clips them."""
    # A NaN (a constant axis) counts in bin 0 rather than breaking bincount.
    idx = torch.nan_to_num(torch.floor(scaled).clamp(0, bins - 1), nan=0.0).long()
    rows = idx.reshape(-1, idx.shape[-1])
    offsets = torch.arange(rows.shape[0], device=idx.device)[:, None] * bins
    counts = torch.bincount((rows + offsets).reshape(-1), minlength=rows.shape[0] * bins)
    return counts.reshape(*scaled.shape[:-1], bins).to(torch.float32)


def _interp_small(x, xp, fp):
    """np.interp(x, xp, fp) along the last axis for small monotone tables,
    batched over the leading axes."""
    n = xp.shape[-1]
    idx = torch.searchsorted(xp.contiguous(), x.contiguous()).clamp(1, n - 1)
    x0, x1 = torch.gather(xp, -1, idx - 1), torch.gather(xp, -1, idx)
    f0, f1 = torch.gather(fp, -1, idx - 1), torch.gather(fp, -1, idx)
    t = torch.where(x1 > x0, (x - x0) / (x1 - x0), 0.0)
    out = f0 + t * (f1 - f0)
    out = torch.where(x <= xp[..., :1], fp[..., :1], out)
    return torch.where(x >= xp[..., -1:], fp[..., -1:], out)


def _histogram_transfer_axes(d0, d1, bins):
    """CDF matching of every rotated axis at once. d0 (F, 3, N) and d1
    (F or 1, 3, M) are the target's and reference's projections (their
    pixel counts may differ). Returns the transported d0."""
    lo = torch.minimum(d0.amin(dim=-1), d1.amin(dim=-1))  # (F, 3)
    hi = torch.maximum(d0.amax(dim=-1), d1.amax(dim=-1))
    step = (hi - lo) / bins

    def cdf(d):
        scaled = (d - lo[..., None]) / (hi - lo)[..., None] * bins
        cp = torch.cumsum(_uniform_histograms(scaled, bins), dim=-1)
        return cp / cp[..., -1:]

    # f maps target quantiles onto reference bin positions (the upper bin
    # edges); each sample then moves along its axis's table (B3).
    edges_tail = lo[..., None] + step[..., None] * torch.arange(
        1, bins + 1, dtype=lo.dtype, device=lo.device)
    f = _interp_small(cdf(d0), cdf(d1), edges_tail)
    # right_edge = hi: the exact final histogram edge (the joint maximum).
    return transport_apply(d0.contiguous(), (lo + step).contiguous(), step.contiguous(),
                           f.contiguous(), hi.contiguous())


def random_rotations(generator, n_iter, dim=3):
    """(n_iter, 3, 3) random rotations (det +1) from ``generator``: modified
    Gram-Schmidt over Gaussian columns and a cross product for the third
    axis, the JAX package's construction. A torch Generator gives another
    stream than jax.random, so the same seed gives other rotations."""
    if dim != 3:
        raise ValueError("random_rotations supports dim=3 (colour axes) only")
    g = torch.randn((n_iter, dim, dim), generator=generator, dtype=torch.float32)
    c0 = g[:, :, 0]
    c0 = c0 / torch.linalg.vector_norm(c0, dim=1, keepdim=True)
    c1 = g[:, :, 1] - (c0 * g[:, :, 1]).sum(dim=1, keepdim=True) * c0
    c1 = c1 / torch.linalg.vector_norm(c1, dim=1, keepdim=True)
    c2 = torch.linalg.cross(c0, c1, dim=1)
    return torch.stack([c0, c1, c2], dim=2)


def _resolve_rotations(rotations, generator, n_iter, device):
    if rotations is None:
        if generator is None:
            generator = torch.Generator().manual_seed(DEFAULT_SEED)
        rotations = random_rotations(generator, n_iter)
    if not torch.is_tensor(rotations):  # numpy, e.g. the JAX package's rotations
        rotations = torch.from_numpy(np.array(rotations, dtype=np.float32))
    rotations = rotations.to(torch.float32)
    if rotations.shape != (n_iter, 3, 3):
        raise ValueError(f"rotations must be ({n_iter}, 3, 3), got {tuple(rotations.shape)}")
    return rotations.to(device)


@full_f32_inference()
def iterative_distribution_transfer_batched(target, reference, bins=255, n_iter=4,
                                            rotations=None, generator=None):
    if bins > MAX_BINS:
        raise ValueError(
            f"bins must be <= {MAX_BINS} (got {bins}): the JAX package's "
            "histogram and table kernels take bin indices below 256"
        )
    rotations = _resolve_rotations(rotations, generator, n_iter, target.device)
    # Planar (F, 3, N) layout; the JAX package's (N, 3) transposes are layout.
    t = target.reshape(target.shape[0], -1, 3).transpose(1, 2)
    r = reference.reshape(reference.shape[0], -1, 3).transpose(1, 2)
    for rot in rotations:
        d0 = rot @ t
        d = _histogram_transfer_axes(d0, rot @ r, bins)
        # rot is orthogonal with det +1: solve(rot, x) == rot.T @ x.
        t = rot.T @ (d - d0) + t
    return t.transpose(1, 2).reshape(target.shape)


@per_image(iterative_distribution_transfer_batched)
def iterative_distribution_transfer(target, reference, bins=255, n_iter=4,
                                    rotations=None, generator=None):
    """Iterative Distribution Transfer (Pitie et al. 2007) of (..., 3)
    target/reference in [0, 1]. ``rotations`` (n_iter, 3, 3) as a tensor or
    numpy array, else drawn from ``generator`` (default: seed 42)."""


def _solve_invariants(img_in, img_col, level, eps=1e-6, rho=1.0 / 5.0):
    """The sweeps' loop-invariant fields: edge-adaptive weights phi1..4,
    the folded constant term and the damped inverse denominator."""
    delta_x = shift_left(img_in) - shift_right(img_in)
    delta_y = shift_up(img_in) - shift_down(img_in)
    delta = torch.sqrt((delta_x**2 + delta_y**2).sum(dim=-1, keepdim=True))
    psi = torch.clamp_max(256.0 * delta / 5.0, 1.0)
    phi = 30.0 * 2.0 ** (-level) / (1.0 + 10.0 * delta)
    phi1 = (shift_left(phi) + phi) / 2.0
    phi2 = (shift_up(phi) + phi) / 2.0
    phi3 = (shift_right(phi) + phi) / 2.0
    phi4 = (shift_down(phi) + phi) / 2.0
    den = psi + phi1 + phi2 + phi3 + phi4 + eps
    const = (
        psi * img_col
        + phi1 * (img_in - shift_left(img_in))
        + phi2 * (img_in - shift_up(img_in))
        + phi3 * (img_in - shift_right(img_in))
        + phi4 * (img_in - shift_down(img_in))
    )
    return const, (phi1, phi2, phi3, phi4), (1.0 - rho) / den


def _solve(img_out, img_in, img_col, nbit, level, eps=1e-6, rho=1.0 / 5.0):
    """One pyramid level: the invariants, then ``nbit`` sweeps (B4 on CUDA)
    on (..., H, W, 3) images."""
    const, phis, inv_den = _solve_invariants(img_in, img_col, level, eps=eps, rho=rho)
    phis = torch.stack([p[..., 0] for p in phis], dim=-3)
    return regrain_sweeps(img_out.contiguous(), const.contiguous(), phis,
                          inv_den[..., 0].contiguous(), nbit, rho=rho)


def _regrain(img_in, img_col, nbits=NBITS, level=0):
    """Multiscale regrain pyramid on (..., H, W, 3) images: solve the
    half-size level first while both halves exceed 20 pixels and sweep
    counts remain, upsample its result as this level's start."""
    h, w = img_in.shape[-3], img_in.shape[-2]
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    if len(nbits) > 1 and h2 > 20 and w2 > 20:
        def half(x):  # the resizes work on channels-first planes
            return torch.movedim(resize_antialias(torch.movedim(x, -1, -3), (h2, w2)), -3, -1)

        small_out = _regrain(half(img_in), half(img_col), nbits[1:], level + 1)
        img_out = torch.movedim(
            resize_bilinear(torch.movedim(small_out, -1, -3), (h, w)), -3, -1)
    else:
        img_out = img_in
    return _solve(img_out, img_in, img_col, nbits[0], level)


@full_f32_inference()
def automated_color_grading_batched(target, reference, bins=255, n_iter=4,
                                    rotations=None, generator=None):
    graded = iterative_distribution_transfer_batched(
        target, reference, bins=bins, n_iter=n_iter, rotations=rotations,
        generator=generator)
    return _regrain(target, graded)


@per_image(automated_color_grading_batched)
def automated_color_grading(target, reference, bins=255, n_iter=4,
                            rotations=None, generator=None):
    """Automated Colour Grading (Pitie et al. 2007): IDT, then the regrain
    pyramid, on (H, W, 3) target/reference in [0, 1]."""
