"""Regrain Jacobi sweeps — all ``nbit`` damped-Jacobi sweeps of one pyramid
level of automated colour grading's regrain solver.

Port of color_transfer_tpu/ops/regrain_stencil.py's
``regrain_sweeps_pallas`` (kernel ``_sweep_kernel``), whose plain statement
is the ``fori_loop`` of ``_solve`` in color_transfer_tpu/methods/iterative.py:

    out <- (const + phi1*L(out) + phi2*U(out) + phi3*R(out) + phi4*D(out))
           * inv_den + rho * out

with edge-replicated shifts. The names are the JAX package's: L
(``shift_left``) reads x+1, U y+1, R x-1 and D y-1.

Two implementations of one function:
  * ``regrain_sweeps_plain`` — plain torch, one sweep at a time;
  * the CUDA kernel in csrc/regrain_stencil.cu (hand-written for sm_90a;
    one cooperative launch per level; its header says what bounds it).

``regrain_sweeps`` routes by device: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel at every level size or raises. The TPU
path's VMEM limit (``level_fits_vmem``) has no counterpart here. Its
``launches`` attribute counts kernel launches.
"""

import ctypes

import torch


def shift_down(a):
    """(..., H, W, C) rows shifted down, the first row repeated."""
    return torch.cat([a[..., :1, :, :], a[..., :-1, :, :]], dim=-3)


def shift_right(a):
    """Columns shifted right, the first column repeated."""
    return torch.cat([a[..., :, :1, :], a[..., :, :-1, :]], dim=-2)


def shift_up(a):
    """Rows shifted up (reads y+1), the last row repeated."""
    return torch.cat([a[..., 1:, :, :], a[..., -1:, :, :]], dim=-3)


def shift_left(a):
    """Columns shifted left (reads x+1), the last column repeated."""
    return torch.cat([a[..., :, 1:, :], a[..., :, -1:, :]], dim=-2)


def regrain_sweeps_plain(img_out, const, phis, inv_den, nbit, rho=0.2):
    """img_out/const (..., H, W, 3); phis (..., 4, H, W) = [phi1 (L),
    phi2 (U), phi3 (R), phi4 (D)]; inv_den (..., H, W) holding
    (1 - rho) / den. Returns (..., H, W, 3) after ``nbit`` sweeps."""
    p1, p2, p3, p4 = (p[..., None] for p in phis.unbind(-3))
    invd = inv_den[..., None]
    out = img_out
    for _ in range(nbit):
        num = (const + p1 * shift_left(out) + p2 * shift_up(out)
               + p3 * shift_right(out) + p4 * shift_down(out))
        out = num * invd + rho * out
    return out


def check_kernel_inputs(img_out, const, phis, inv_den):
    """Raise ValueError for inputs the CUDA kernel does not take: float32
    contiguous tensors on one device, img_out/const (..., H, W, 3), phis
    (..., 4, H, W), inv_den (..., H, W)."""
    shape = img_out.shape
    if img_out.ndim < 3 or shape[-1] != 3:
        raise ValueError(f"img_out must be (..., H, W, 3), got {tuple(shape)}")
    lead, (h, w) = shape[:-3], shape[-3:-1]
    want = {"img_out": shape, "const": shape, "phis": (*lead, 4, h, w),
            "inv_den": (*lead, h, w)}
    for name, t in (("img_out", img_out), ("const", const), ("phis", phis),
                    ("inv_den", inv_den)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != img_out.device:
            raise ValueError(f"{name}: on {t.device}, img_out on {img_out.device}")
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"{name} must be {tuple(want[name])}, got {tuple(t.shape)}")


def _launch(img_out, const, phis, inv_den, nbit, rho):
    check_kernel_inputs(img_out, const, phis, inv_den)
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("regrain_stencil").regrain_sweeps_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    h, w = img_out.shape[-3], img_out.shape[-2]
    frames = img_out.numel() // (3 * h * w)
    bufs = [torch.empty_like(img_out), torch.empty_like(img_out) if nbit > 1 else None]
    with torch.cuda.device(img_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img_out.data_ptr(), const.data_ptr(), phis.data_ptr(),
                 inv_den.data_ptr(), bufs[0].data_ptr(),
                 bufs[1].data_ptr() if bufs[1] is not None else None,
                 frames, h, w, nbit, rho, stream)
    if err != 0:
        raise RuntimeError(f"regrain_sweeps_forward launch failed: CUDA error {err}")
    regrain_sweeps.launches += 1
    return bufs[(nbit - 1) % 2]


def regrain_sweeps(img_out, const, phis, inv_den, nbit, rho=0.2):
    """All ``nbit`` sweeps of one level (shapes as regrain_sweeps_plain).
    CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/regrain_stencil.cu) in one launch, with no
    fallback: a failed build or launch raises."""
    if nbit < 1:
        raise ValueError(f"nbit must be >= 1, got {nbit}")
    if img_out.device.type == "cpu":
        return regrain_sweeps_plain(img_out, const, phis, inv_den, nbit, rho)
    if img_out.device.type != "cuda":
        raise ValueError(f"unsupported device {img_out.device}")
    return _launch(img_out, const, phis, inv_den, nbit, rho)


regrain_sweeps.launches = 0
