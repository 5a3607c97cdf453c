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
    the sweeps run in shared memory, sized by ``launch_plan``: trapezoid
    passes of several sweeps over haloed tiles for the large levels, a
    thread block cluster per frame for all the sweeps of a small level; its
    header says what bounds it).

``regrain_sweeps`` routes by device: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel at every level size or raises. The TPU
path's VMEM limit (``level_fits_vmem``) has no counterpart here. The
counter ``regrain_stencil.launches`` (utils/profiling.py) counts calls (one
a level); a trapezoid call makes one device launch a pass
(``LevelPlan.passes``).
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from color_transfer_tpu_torch.utils import profiling

# csrc/regrain_stencil.cu's limits: a thread owns S rows (its strip) of
# four adjacent columns, whose 32 S invariants sit in registers, so a block
# of strip height S has at most MAX_THREADS[S - 1] threads; a cluster at
# most 8 blocks (the portable size); a block at most 227 KB of shared
# memory, two channel-major buffers of its region, rows padded to a
# multiple of four columns.
MAX_THREADS = (640, 512, 384, 256)
VX = 4
MAX_CLUSTER = 8
SMEM_LIMIT = 227 * 1024
# The trapezoid route's blocks take at most half an SM's shared memory and
# registers, so two blocks share an SM (one loads while the other sweeps),
# and strips of at most two rows: at three and four rows a thread takes 168
# and 221 registers (nvcc's report), and the few warps an SM then holds ran
# the large levels slower.
TRAPEZOID_SMEM = SMEM_LIMIT // 2
TRAPEZOID_MAX_STRIP = 2
TILE_ROWS = (8, 16, 24, 32, 48, 64)
TILE_COLS = (16, 24, 32, 48, 56, 64, 96, 120, 128, 248)
# The trapezoid cost model, in bytes of device memory a level: each pass
# reads the 44 bytes of a pixel's inputs and writes its 12 (56), plus the
# halo's inputs again (HALO_WEIGHT of a byte each); each pixel-sweep
# computed in shared memory, halo included, costs as much time as
# SWEEP_BYTES bytes of device memory. The weights make the model rank the
# plans as the card did at the three large 1080p levels (passes of 4 sweeps
# over 24 x 56 tiles first).
PASS_BYTES, HALO_WEIGHT, SWEEP_BYTES = 56, 1.0, 20.0


def _smem(rows, cols):
    """Shared memory of a region: two buffers of three channel planes."""
    return 2 * 3 * rows * (-(-cols // VX) * VX) * 4


class LevelPlan(NamedTuple):
    """How csrc/regrain_stencil.cu runs one level. route "trapezoid":
    passes of ``sweeps`` sweeps (the last takes the rest) over tile_h x
    tile_w tiles; route "cluster": one launch of all the sweeps, clusters
    of ``cluster`` blocks of tile_h rows (tile_w = W). ``strip``: a
    thread's rows (of four columns); ``threads`` and ``smem`` (bytes): the
    block."""

    route: str
    sweeps: int
    passes: int
    tile_h: int
    tile_w: int
    strip: int
    threads: int
    smem: int
    cluster: int


def _strip_for(rows, cols, share=1, max_strip=len(MAX_THREADS)):
    """The least strip height (and its threads) whose ceil(rows / S) x
    ceil(cols / 4) threads fit the block (``share`` blocks an SM), or
    None."""
    for s in range(1, max_strip + 1):
        threads = -(-rows // s) * -(-cols // VX)
        if threads <= MAX_THREADS[s - 1] // share:
            return s, threads
    return None


def _cluster_plan(h, w, nbit):
    """The most blocks (up to MAX_CLUSTER, the least rows a block) that
    hold a frame's level, or None when it does not fit a cluster."""
    for band in range(-(-h // MAX_CLUSTER), h + 1):
        smem = _smem(band, w)
        fit = _strip_for(band, w)
        if fit is not None and smem <= SMEM_LIMIT:
            return LevelPlan("cluster", nbit, 1, band, w, fit[0], fit[1], smem,
                             -(-h // band))
    return None


def _spans(n, tile, s, k):
    """Sum over the tiles along one axis (size n, tiles of ``tile``) of the
    length of the region valid after sweep k of a pass of s sweeps (k = 0:
    the loaded region), clipped to the image."""
    return sum(min(n, t + tile + s - k) - max(0, t - s + k) for t in range(0, n, tile))


def _trapezoid_cost(h, w, nbit, s, th, tw):
    """The cost model's bytes for a level in passes of s sweeps."""
    cost = 0.0
    for done in range(0, nbit, s):
        sp = min(s, nbit - done)
        region = _spans(h, th, sp, 0) * _spans(w, tw, sp, 0)
        swept = sum(_spans(h, th, sp, k) * _spans(w, tw, sp, k) for k in range(1, sp + 1))
        cost += PASS_BYTES * h * w + HALO_WEIGHT * 44 * (region - h * w) + SWEEP_BYTES * swept
    return cost


@functools.cache
def launch_plan(h, w, nbit):
    """The kernel's plan for one level of (H, W) with ``nbit`` sweeps: the
    cluster route when a cluster's shared memory holds the frame's level,
    else the trapezoid route at the sweeps-a-pass and tile that the cost
    model rates cheapest (halo bytes and recomputed pixels against passes)."""
    if min(h, w, nbit) < 1:
        raise ValueError(f"empty level ({h}, {w}) or nbit {nbit}")
    plan = _cluster_plan(h, w, nbit)
    if plan is not None:
        return plan
    best = None
    for s in sorted({min(nbit, 2**e) for e in range(7)}):
        for th in TILE_ROWS:
            for tw in TILE_COLS:
                rh, rw = th + 2 * s, tw + 2 * s
                smem = _smem(rh, rw)
                fit = _strip_for(rh, rw, share=2, max_strip=TRAPEZOID_MAX_STRIP)
                if fit is None or smem > TRAPEZOID_SMEM:
                    continue
                cost = _trapezoid_cost(h, w, nbit, s, th, tw)
                if best is None or cost < best[0]:
                    best = (cost, LevelPlan("trapezoid", s, -(-nbit // s), th, tw, fit[0],
                                            fit[1], smem, 1))
    return best[1]


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
    (..., 4, H, W), inv_den (..., H, W), fewer than 65,536 frames (the
    launch grid's frame dimension)."""
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
    if img_out.numel() // (3 * max(1, h * w)) >= 2**16:
        raise ValueError(f"{tuple(shape)}: too many frames for the launch grid")


def _launch(img_out, const, phis, inv_den, nbit, rho, plan=None):
    """Launch the kernel as ``launch_plan`` sizes it (or as ``plan`` does:
    the card tests force each route with it)."""
    check_kernel_inputs(img_out, const, phis, inv_den)
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("regrain_stencil").regrain_sweeps_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h, w = img_out.shape[-3], img_out.shape[-2]
    frames = img_out.numel() // (3 * h * w)
    plan = plan or launch_plan(h, w, nbit)
    bufs = [torch.empty_like(img_out), torch.empty_like(img_out) if plan.passes > 1 else None]
    with torch.cuda.device(img_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img_out.data_ptr(), const.data_ptr(), phis.data_ptr(),
                 inv_den.data_ptr(), bufs[0].data_ptr(),
                 bufs[1].data_ptr() if bufs[1] is not None else None,
                 frames, h, w, nbit, rho, int(plan.route == "cluster"), plan.sweeps,
                 plan.tile_h, plan.tile_w, plan.strip, plan.cluster, plan.threads,
                 plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"regrain_sweeps_forward launch failed: CUDA error {err}")
    profiling.count("regrain_stencil.launches")
    return bufs[(plan.passes - 1) % 2]


def regrain_sweeps(img_out, const, phis, inv_den, nbit, rho=0.2):
    """All ``nbit`` sweeps of one level (shapes as regrain_sweeps_plain).
    CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/regrain_stencil.cu) as ``launch_plan`` sizes
    it, with no fallback: a failed build or launch raises."""
    if nbit < 1:
        raise ValueError(f"nbit must be >= 1, got {nbit}")
    if img_out.device.type == "cpu":
        return regrain_sweeps_plain(img_out, const, phis, inv_den, nbit, rho)
    if img_out.device.type != "cuda":
        raise ValueError(f"unsupported device {img_out.device}")
    return _launch(img_out, const, phis, inv_den, nbit, rho)
