"""Bilinear warp adjoint — the feature cotangent of ``flow_warp_batched``.

Port of color_transfer_tpu/core/sampling.py's ``_adjoint_warp_pallas``
(kernel ``_bilinear_scatter_kernel``) plus the crop of
``_flow_warp_batched_bwd``; its plain statement is ``_adjoint_warp_xla``:
every pixel's cotangent g[b, p, :], times its four bilinear corner weights,
is scatter-added into a zero (B, H+4, W+4, C) buffer at the corners of the
clamped sample position, and the buffer is cropped to [2:2+H, 2:2+W].

Two implementations of one function:
  * ``warp_adjoint_plain`` — plain torch, one ``index_put_`` with
    ``accumulate=True`` of the pre-weighted corner updates into the
    flattened padded buffer;
  * the CUDA kernel in csrc/warp_adjoint.cu (hand-written for sm_90a; its
    header says what bounds it and how it is laid out).

``warp_adjoint`` routes by device: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. The counter
``warp_adjoint.launches`` (utils/profiling.py) counts kernel launches,
``warp_adjoint.vector_launches`` those that took the kernel's vector path
(``vector_path``; the rest add channel by channel). Float atomics add in a
varying order, so the kernel agrees with the plain version to rounding, not
bit for bit.
"""

import ctypes
import functools

import torch

from color_transfer_tpu_torch.utils import profiling


def warp_corners(flow, h, w):
    """Flattened padded-buffer row of each pixel's top-left corner and its
    four corner weights. The geometry is the JAX package's
    ``_warp_geometry``, stated here as the kernel states it: the sample
    position p + flow(p) clamped into [-1.5, S + 0.5], its floor offset by
    the 2-pixel band, and the bilinear fractions.

    flow (B, H, W, 2) -> rows (B, H, W) int64 into the (B * (H+4) * (W+4))
    rows of the padded buffer, weights (B, H, W, 4) in the order (y0, x0),
    (y0, x0+1), (y0+1, x0), (y0+1, x0+1)."""
    b = flow.shape[0]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    x = (xs + flow[..., 0]).clamp(-1.5, w + 0.5)
    y = (ys + flow[..., 1]).clamp(-1.5, h + 0.5)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    bidx = torch.arange(b, device=flow.device).reshape(b, 1, 1)
    rows = ((bidx * (h + 4) + y0.long() + 2) * (w + 4)) + x0.long() + 2
    weights = torch.stack(
        [(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=-1
    )
    return rows, weights


def warp_adjoint_plain(g, flow):
    """Plain torch version: g (B, H, W, C), flow (B, H, W, 2) -> the feature
    cotangent (B, H, W, C)."""
    b, h, w, c = g.shape
    rows, weights = warp_corners(flow, h, w)
    offsets = torch.tensor([0, 1, w + 4, w + 5], device=g.device)
    index = (rows[..., None] + offsets).reshape(-1)
    updates = (weights[..., None] * g[..., None, :]).reshape(-1, c)
    padded = torch.zeros(b * (h + 4) * (w + 4), c, dtype=g.dtype, device=g.device)
    padded.index_put_((index,), updates, accumulate=True)
    return padded.reshape(b, h + 4, w + 4, c)[:, 2 : 2 + h, 2 : 2 + w]


def check_kernel_inputs(g, flow):
    """Raise ValueError for inputs the CUDA kernel does not take: float32
    contiguous tensors on one device, g (B, H, W, C) and flow (B, H, W, 2)."""
    for name, t in (("g", g), ("flow", flow)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if flow.device != g.device:
        raise ValueError(f"flow on {flow.device}, g on {g.device}")
    if g.ndim != 4 or tuple(flow.shape) != (*g.shape[:3], 2):
        raise ValueError(
            f"g must be (B, H, W, C) and flow (B, H, W, 2), got "
            f"{tuple(g.shape)} and {tuple(flow.shape)}"
        )


def vector_path(g, padded):
    """Whether the kernel takes its vector path (16-byte reductions): C a
    multiple of 4 and both buffers 16-byte aligned. Otherwise it adds
    channel by channel."""
    return g.shape[-1] % 4 == 0 and g.data_ptr() % 16 == 0 and padded.data_ptr() % 16 == 0


@functools.cache
def _kernel():
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("warp_adjoint").warp_adjoint_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g, flow):
    check_kernel_inputs(g, flow)
    fn = _kernel()
    b, h, w, c = g.shape
    # Zeroed by the launch function (cudaMemsetAsync), inside the kernel's time.
    padded = torch.empty(b, h + 4, w + 4, c, dtype=g.dtype, device=g.device)
    vec4 = vector_path(g, padded)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), flow.data_ptr(), padded.data_ptr(), b, h, w, c, int(vec4),
                 stream)
    if err != 0:
        raise RuntimeError(f"warp_adjoint_forward launch failed: CUDA error {err}")
    profiling.count("warp_adjoint.launches")
    if vec4:
        profiling.count("warp_adjoint.vector_launches")
    return padded[:, 2 : 2 + h, 2 : 2 + w]


def warp_adjoint(g, flow):
    """The feature cotangent of the zeros-padding backward warp: g (B, H, W,
    C), flow (B, H, W, 2) -> (B, H, W, C), a view of the cropped padded
    buffer. CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/warp_adjoint.cu), with no fallback: a failed
    build or launch raises. The caller makes g and flow contiguous."""
    if g.device.type == "cpu":
        return warp_adjoint_plain(g, flow)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return _launch(g, flow)
