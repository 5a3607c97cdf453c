"""Fused ResB conv chain — DCMCS3DI's extraction and transfer stacks.

A chain of ResB blocks (conv3x3 -> LeakyReLU(0.01) -> conv3x3 -> +identity)
over an NHWC input, with the convolutions in a compute dtype (bf16 or f32)
accumulating in f32. Port of color_transfer_tpu/ops/conv_chain.py
(``resb_chain``, the Pallas ``_group_kernel``).

Per block, as the TPU kernel rounds:
    y = cd(LeakyReLU(conv3x3(x) + b0))
    x = cd(x + cd(conv3x3(y) + b1))
with cd() the rounding to the compute dtype and 'same' zero padding at the
image edges.

Two implementations of one function:
  * ``resb_chain_plain`` — plain torch: ``F.conv2d`` in f32 on operands
    rounded to the compute dtype, then the epilogue's rounding (what the
    JAX kernel computes in interpret mode);
  * the CUDA kernel in csrc/resb_chain.cu (hand-written for sm_90a; see its
    header for what bounds it and how it is laid out): one launch per conv,
    two per block, the second writing the block's output in place.

``resb_chain`` routes by device: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. Its ``launches`` attribute counts
kernel launches (one per conv).
"""

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/resb_chain.cu
_CHANNELS = (16, 32, 64)  # instantiated in csrc/resb_chain.cu
_TILE = {torch.float32: (8, 16), torch.bfloat16: (32, 16)}  # rows, pixels


def _conv_f32(x, kernel, bias):
    """3x3 'same' conv of NHWC ``x`` with an HWIO ``kernel``: f32 products
    of the given (already rounded) values, f32 bias. cuDNN's TF32 (on by
    default in PyTorch) is off for the call: this is the reference."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(x.permute(0, 3, 1, 2).float(),
                       kernel.permute(3, 2, 0, 1).float(), bias.float(), padding=1)
    return out.permute(0, 2, 3, 1)


def resb_chain_plain(x, kernels, biases, compute_dtype=torch.bfloat16):
    """Plain torch version: x (B, H, W, C), kernels (L, 2, 3, 3, C, C) HWIO,
    biases (L, 2, C) -> (B, H, W, C) float32."""
    cd = compute_dtype
    x = x.to(cd)
    kernels = kernels.to(cd)
    for blk in range(kernels.shape[0]):
        y = _conv_f32(x, kernels[blk, 0], biases[blk, 0])
        y = torch.where(y >= 0, y, 0.01 * y).to(cd)
        z = _conv_f32(y, kernels[blk, 1], biases[blk, 1]).to(cd)
        x = (x.float() + z.float()).to(cd)
    return x.float()


def check_kernel_inputs(x, kernels, biases, compute_dtype):
    """Raise ValueError for inputs the CUDA kernel does not take: a 4-D
    floating (B, H, W, C) input with C in {16, 32, 64} and fewer than 2^31
    elements, floating (L, 2, 3, 3, C, C) kernels and (L, 2, C) biases, all
    on one device, compute dtype float32 or bfloat16. (The wrapper copies
    them into contiguous, aligned buffers of the compute dtype.)"""
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    for name, t in (("x", x), ("kernels", kernels), ("biases", biases)):
        if not t.is_floating_point():
            raise ValueError(f"{name}: floating dtype required, got {t.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x: (B, H, W, C) required, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c not in _CHANNELS:
        raise ValueError(f"C must be one of {_CHANNELS}, got {c}")
    if min(b, h, w) < 1 or x.numel() >= 2**31:
        raise ValueError(f"input {tuple(x.shape)} empty or too large for the kernel")
    n_layers = kernels.shape[0]
    if tuple(kernels.shape) != (n_layers, 2, 3, 3, c, c):
        raise ValueError(f"kernels must be (L, 2, 3, 3, {c}, {c}), got {tuple(kernels.shape)}")
    if tuple(biases.shape) != (n_layers, 2, c):
        raise ValueError(f"biases must be ({n_layers}, 2, {c}), got {tuple(biases.shape)}")
    if not (x.device == kernels.device == biases.device):
        raise ValueError("x, kernels and biases must share one device")


def _launch(x, kernels, biases, cd):
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, kernels, biases)
    ):
        raise RuntimeError(
            "resb_chain: the CUDA kernel is forward-only; run it under "
            "torch.no_grad()"
        )
    check_kernel_inputs(x, kernels, biases, cd)
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("resb_chain").resb_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, h, w, c = x.shape
    n_layers = kernels.shape[0]
    # Fresh buffers (16-byte aligned by the allocator): the chain updates x
    # in place, so the caller's tensor is never written.
    xc = x.to(dtype=cd, memory_format=torch.contiguous_format, copy=True)
    y = torch.empty_like(xc)
    wk = kernels.to(cd).reshape(n_layers, 2, 9, c, c).contiguous()
    bs = biases.float().contiguous()
    rows, cols = _TILE[cd]
    n_tiles = b * -(-h // rows) * -(-w // cols)
    grid = min(n_tiles, torch.cuda.get_device_properties(x.device).multi_processor_count)
    code = _DTYPE_CODES[cd]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for blk in range(n_layers):
            for j, (src, res, dst) in enumerate(((xc, None, y), (y, xc, xc))):
                err = fn(src.data_ptr(), wk[blk, j].data_ptr(),
                         bs[blk, j].data_ptr(),
                         None if res is None else res.data_ptr(), dst.data_ptr(),
                         b, h, w, c, int(j == 0), code, grid, stream)
                if err != 0:
                    raise RuntimeError(f"resb_conv3x3 launch failed: CUDA error {err}")
                resb_chain.launches += 1
    return xc.float()


def resb_chain(x, kernels, biases, compute_dtype=torch.bfloat16):
    """Chain of ResB blocks over NHWC ``x``: kernels (L, 2, 3, 3, C, C) in
    the JAX package's HWIO layout, biases (L, 2, C) -> (B, H, W, C) float32.
    CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/resb_chain.cu), with no fallback: a failed
    build or launch raises."""
    if x.device.type == "cpu":
        return resb_chain_plain(x, kernels, biases, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, kernels, biases, compute_dtype)


resb_chain.launches = 0
