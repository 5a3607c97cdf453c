"""Global / linear colour-transfer methods — port of
color_transfer_tpu/methods/linear.py.

Each method has a per-image form, ``fn(target, reference)`` on (H, W, 3)
tensors in [0, 1] (any (..., 3) shape: every sample is one pixel), and a
batched form ``fn.batched(target, reference)`` on (F, ..., 3) chunks, with
statistics per frame; a reference with F = 1 serves every frame (the video
path's global mode). The JAX package vmaps the per-image form; the port
writes the batch axis out. Both forms run without gradients and with TF32
off (``core/precision.py``), as the JAX package's f32 paths do.

  * reinhard               — Lab mean/std matching (Reinhard et al. 2001)
  * correlated_color_space — RGB covariance matching through eigen
                             decompositions (Xiao & Ma 2006)
  * monge_kantorovitch     — the linear optimal-transport map between the
                             covariances (Pitie & Kokaram 2007)
"""

import torch

from color_transfer_tpu_torch.core.colorspace import lab_to_rgb, rgb_to_lab
from color_transfer_tpu_torch.core.linalg import cov3, inv_sqrtm_psd, sqrtm_psd
from color_transfer_tpu_torch.core.precision import full_f32_inference

DECOMPOSITIONS = ("cholesky", "sqrt", "MK")


def _flatten(x):
    return x.reshape(x.shape[0], -1, 3)


def per_image(batched):
    """The per-image method of a batched one: adds a frame axis of 1 and
    takes it away; the batched form is its ``batched`` attribute."""

    def decorate(fn):
        def call(target, reference, *args, **kwargs):
            return batched(target[None], reference[None], *args, **kwargs)[0]

        call.__name__, call.__qualname__ = fn.__name__, fn.__qualname__
        call.__doc__, call.__module__ = fn.__doc__, fn.__module__
        call.batched = batched
        return call

    return decorate


@full_f32_inference()
def reinhard_batched(target, reference):
    t = _flatten(rgb_to_lab(target))
    r = _flatten(rgb_to_lab(reference))
    t_mean, r_mean = t.mean(dim=1, keepdim=True), r.mean(dim=1, keepdim=True)
    # ddof 0, as jnp.std (torch.std defaults to the unbiased estimate).
    t_std = t.std(dim=1, correction=0, keepdim=True)
    r_std = r.std(dim=1, correction=0, keepdim=True)
    out = (t - t_mean) * r_std / t_std + r_mean
    return lab_to_rgb(out.reshape(target.shape))


@per_image(reinhard_batched)
def reinhard(target, reference):
    """Colour Transfer between Images (Reinhard et al. 2001): per-channel
    Lab mean/std matching, out = (t - mu_t) * sigma_r / sigma_t + mu_r."""


def _sorted_eig_desc(c):
    """Symmetric eigendecomposition sorted by descending eigenvalue
    (``torch.linalg.eigh`` sorts ascending)."""
    vals, vecs = torch.linalg.eigh(c)
    return vals.flip(-1), vecs.flip(-1)


def _align_axes(u_ref, u_target):
    """Flip the reference eigenvectors' signs so that each axis points along
    its paired target axis (eigenvector signs are arbitrary)."""
    signs = torch.sign((u_ref * u_target).sum(dim=-2, keepdim=True))
    return u_ref * torch.where(signs == 0, 1.0, signs)


@full_f32_inference()
def correlated_color_space_batched(target, reference):
    t, r = _flatten(target), _flatten(reference)
    t_mean, r_mean = t.mean(dim=1, keepdim=True), r.mean(dim=1, keepdim=True)
    s_t, u_t = _sorted_eig_desc(cov3(t))
    s_r, u_r = _sorted_eig_desc(cov3(r))
    u_r = _align_axes(u_r, u_t)
    eps = 1e-12
    # u_t diag(1/sqrt(s_t)) diag(sqrt(s_r)) u_r^T; the diagonal products are
    # column scalings, as the JAX package's matmuls by diagonals compute.
    scaled = u_t * (1.0 / torch.sqrt(torch.clamp_min(s_t, eps)))[:, None, :]
    scaled = scaled * torch.sqrt(torch.clamp_min(s_r, eps))[:, None, :]
    transform = scaled @ u_r.transpose(-1, -2)
    out = (t - t_mean) @ transform.transpose(-1, -2) + r_mean
    return out.reshape(target.shape)


@per_image(correlated_color_space_batched)
def correlated_color_space(target, reference):
    """Colour Transfer in Correlated Colour Space (Xiao & Ma 2006):
    T = U_t diag(1/sqrt(s_t)) diag(sqrt(s_r)) U_r^T from symmetric eigen
    pairs, the reference axes' signs aligned to the target's."""


@full_f32_inference()
def monge_kantorovitch_batched(target, reference, decomposition="MK"):
    if decomposition not in DECOMPOSITIONS:
        raise ValueError("Unknown decomposition, use 'cholesky', 'sqrt', or 'MK'")
    t, r = _flatten(target), _flatten(reference)
    t_mean, r_mean = t.mean(dim=1, keepdim=True), r.mean(dim=1, keepdim=True)
    cov_t, cov_r = cov3(t), cov3(r)
    if decomposition == "cholesky":
        transform = torch.linalg.cholesky(cov_r) @ torch.linalg.inv(
            torch.linalg.cholesky(cov_t))
    elif decomposition == "sqrt":
        transform = sqrtm_psd(cov_r) @ inv_sqrtm_psd(cov_t)
    else:
        a = sqrtm_psd(cov_t)
        a_inv = inv_sqrtm_psd(cov_t)
        transform = a_inv @ sqrtm_psd(a @ cov_r @ a) @ a_inv
    # (x - mean) @ T, untransposed as in the JAX package: T is symmetric for
    # 'MK' but not for the other two.
    out = (t - t_mean) @ transform + r_mean
    return out.reshape(target.shape)


@per_image(monge_kantorovitch_batched)
def monge_kantorovitch(target, reference, decomposition="MK"):
    """Linear Monge-Kantorovitch colour mapping (Pitie & Kokaram 2007).
    decomposition in {'cholesky', 'sqrt', 'MK'}; 'MK' (default):
    A = sqrtm(cov_t), T = A^-1 sqrtm(A cov_r A) A^-1, from PSD eigen square
    roots."""
