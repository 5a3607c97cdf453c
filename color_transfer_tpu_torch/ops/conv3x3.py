"""3x3, stride-1, 'same'-padded f32 convolution at 64 -> 64 channels on NHWC
tensors, forward and backward, on a hand-written implicit-GEMM kernel.

Replaces no TPU kernel: the JAX package leaves its convolutions to XLA. It
takes DCMCS3DI's f32 training convolutions (its ResB stacks and the matcher
head's ResB) off ATen's im2col / cuBLAS / col2im route, which the training
step chose over cuDNN because cuDNN's f32 algorithms miss the float64 rule
there (tools/conv_grads.py), and its f32 ResB blocks at inference off
cuDNN's NCHW convolutions. csrc/conv3x3.cu's header says what bounds the
kernels and how they are laid out.

Two implementations of each function:
  * the plain versions: ``conv3x3_plain`` (F.conv2d) and, for the backward,
    ``aten.convolution_backward``, the call autograd makes for F.conv2d;
    ``resb_plain``, a ResB block at inference (F.conv2d, LeakyReLU, add);
  * the CUDA kernels: the forward, the input gradient (the same kernel on
    the output gradient with the weights flipped and their channel roles
    swapped) and the weight and bias gradients (partial sums a band of
    pixels, then a reduce in a fixed order); a ResB block at inference as
    two forward launches whose epilogues apply the LeakyReLU and add the
    block's input, with the bits of conv3x3's forward, ``leaky_relu`` and
    ATen's add.

``conv3x3`` is one ``torch.autograd.Function`` that saves what ATen's
convolution saves (the input and the weight); ``resb`` has no gradient
(``models/layers.py::ResB`` calls it only where autograd records nothing).
A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises, with no fallback. The counters ``conv3x3.launches``,
``.dgrad_launches`` and ``.wgrad_launches`` (utils/profiling.py) count the
Function's forward, input gradient and weight gradient calls that ran the
kernels, ``conv3x3.resb_launches`` the epilogue launches (two a block). The
kernels use no float atomics: two calls give the same bits.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function_variadic

from color_transfer_tpu_torch.utils import profiling

CHANNELS = 64
WEIGHT_SHAPE = (CHANNELS, CHANNELS, 3, 3)
# The weight gradient's scratch: a band's partial sums of the 9 x 64 x 64
# weight gradient and of the bias (a row of 64 from each of its three tap
# rows' blocks), in floats.
PARTIAL_FLOATS = 9 * CHANNELS * CHANNELS + 3 * CHANNELS
# The chains an output's sum of 576 products is cut into (csrc/conv3x3.cu):
# the forward one, in the order of ATen's im2col GEMM; the input gradient 4,
# since one chain put it at 0.105 of the float64 rule's line where ATen,
# which sums 64 products and then the 9 taps, reads 0.024, and 4 read 0.035
# (tools/conv_grads.py on the card; PERF.md).
FORWARD_PARTS, INPUT_GRAD_PARTS = 1, 4
# The forward's epilogues (csrc/conv3x3.cu's ``Epilogue``): the training passes' and
# the two of a ResB block at inference.
BIAS, LEAKY_RELU, RESIDUAL = 0, 1, 2
# LeakyReLU's slope, for resb_plain and models/layers.py::leaky_relu alike
# (the kernel's epilogue writes it as 0.01f).
LEAKY_SLOPE = 0.01


def conv3x3_plain(x, weight, bias=None):
    """Plain torch version: NHWC x (B, H, W, 64), an OIHW weight (64, 64,
    3, 3) and a bias (64) or None -> NHWC (B, H, W, 64)."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1).permute(0, 2, 3, 1)


def resb_plain(x, w0, b0, w1, b1):
    """Plain torch version of a ResB block at inference: NHWC x (B, H, W,
    64) -> x + conv(LeakyReLU(conv(x, W0) + b0), W1) + b1, each step as
    ``models/layers.py``'s ``conv``, ``leaky_relu`` and the residual add
    compute it."""
    y = conv3x3_plain(x, w0, b0)
    y = torch.where(y >= 0, y, y * y.new_tensor(LEAKY_SLOPE))
    return x + conv3x3_plain(y, w1, b1)


def flops(b, h, w):
    """Operations of one pass (forward, input gradient or weight gradient)
    at (b, h, w, 64): two a multiply-add."""
    return 2 * b * h * w * 9 * CHANNELS * CHANNELS


def check_kernel_inputs(x, weight=None, bias=None):
    """Raise ValueError for inputs the kernels do not take: float32 tensors
    on x's device, x (B, H, W, 64), weight (64, 64, 3, 3), bias (64); a
    weight or bias of None is not checked."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 required, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.ndim != 4 or x.shape[-1] != CHANNELS:
        raise ValueError(f"x must be (B, H, W, {CHANNELS}), got {tuple(x.shape)}")
    if weight is not None and tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"weight must be {WEIGHT_SHAPE}, got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (CHANNELS,):
        raise ValueError(f"bias must be ({CHANNELS},), got {tuple(bias.shape)}")


def _dense(t):
    """``t`` as a contiguous tensor whose data is 16-byte aligned (the
    kernels' 16-byte copies): itself when it is one, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _lib():
    from color_transfer_tpu_torch.ops import _build

    lib = _build.load("conv3x3")
    lib.conv3x3_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.conv3x3_wgrad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.conv3x3_wgrad_bands.argtypes = [ctypes.c_void_p]
    for fn in (lib.conv3x3_forward, lib.conv3x3_wgrad, lib.conv3x3_wgrad_bands):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def wgrad_bands(device_index):
    """The weight gradient's band count on a card: its resident blocks over
    the three tap rows (88 on an H100: 132 SMs, two blocks each)."""
    bands = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().conv3x3_wgrad_bands(ctypes.addressof(bands))
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad_bands failed: CUDA error {err}")
    return bands.value


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _run_forward(x, wk, bias, parts, epilogue=BIAS, residual=None):
    """One launch of the forward kernel, with its epilogue (``BIAS`` for
    the training passes)."""
    b, h, w, _ = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().conv3x3_forward(x.data_ptr(), wk.data_ptr(),
                                     None if bias is None else bias.data_ptr(),
                                     None if residual is None else residual.data_ptr(),
                                     y.data_ptr(), b, h, w, parts, epilogue, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_forward launch failed: CUDA error {err}")
    return y


def _forward_weights(weight):
    return weight.permute(1, 2, 3, 0).contiguous()  # [ci][dy][dx][co]


def forward_kernel(x, weight, bias=None):
    """The forward on the card: x (B, H, W, 64) NHWC -> (B, H, W, 64)."""
    check_kernel_inputs(x, weight, bias)
    y = _run_forward(_dense(x), _forward_weights(weight),
                     None if bias is None else bias.contiguous(), FORWARD_PARTS)
    profiling.count("conv3x3.launches")
    return y


def epilogue_kernel(x, weight, bias, epilogue, residual=None):
    """One forward launch with an inference epilogue on the card, x (B, H,
    W, 64) NHWC -> (B, H, W, 64): ``LEAKY_RELU``, LeakyReLU(conv(x, W) +
    b); ``RESIDUAL``, residual + (conv(x, W) + b), ``residual`` shaped as
    x (a ResB block's input)."""
    check_kernel_inputs(x, weight, bias)
    if epilogue == RESIDUAL:
        check_kernel_inputs(residual)
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(f"residual {tuple(residual.shape)} on {residual.device} and x "
                             f"{tuple(x.shape)} on {x.device} differ")
        residual = _dense(residual)
    elif epilogue != LEAKY_RELU:
        raise ValueError(f"unknown epilogue {epilogue}")
    y = _run_forward(_dense(x), _forward_weights(weight),
                     None if bias is None else bias.contiguous(), FORWARD_PARTS, epilogue,
                     residual)
    profiling.count("conv3x3.resb_launches")
    return y


def resb(x, w0, b0, w1, b1):
    """A ResB block at inference, x + conv(LeakyReLU(conv(x, W0) + b0), W1)
    + b1, on NHWC x (B, H, W, 64) with OIHW weights (64, 64, 3, 3) and
    biases (64); no gradient. A CPU tensor takes ``resb_plain``; a CUDA
    tensor runs the two epilogue launches (the activation between them is
    the only temporary) with no fallback."""
    if x.device.type == "cpu":
        return resb_plain(x, w0, b0, w1, b1)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = _dense(x)
    return epilogue_kernel(epilogue_kernel(x, w0, b0, LEAKY_RELU), w1, b1, RESIDUAL, x)


def input_grad_kernel(g, weight):
    """The input gradient on the card: the forward kernel on the output
    gradient g (B, H, W, 64), with W[co, ci, 2 - dy, 2 - dx] as its
    [co][dy][dx][ci] weights and no bias."""
    check_kernel_inputs(g, weight)
    wk = weight.flip(2, 3).permute(0, 2, 3, 1).contiguous()
    gx = _run_forward(_dense(g), wk, None, INPUT_GRAD_PARTS)
    profiling.count("conv3x3.dgrad_launches")
    return gx


def weight_grad_kernel(x, g):
    """The weight (64, 64, 3, 3) and bias (64) gradients on the card from
    the input x and the output gradient g, both (B, H, W, 64)."""
    check_kernel_inputs(x)
    check_kernel_inputs(g)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} and x {tuple(x.shape)} on "
                         f"{x.device} differ")
    x, g = _dense(x), _dense(g)
    b, h, w, _ = x.shape
    bands = wgrad_bands(x.device.index)
    partial = torch.empty(bands, PARTIAL_FLOATS, device=x.device)
    dw = torch.empty(WEIGHT_SHAPE, device=x.device)
    db = torch.empty(CHANNELS, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().conv3x3_wgrad(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                   db.data_ptr(), bands, b, h, w, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad launch failed: CUDA error {err}")
    profiling.count("conv3x3.wgrad_launches")
    return dw, db


class _Conv3x3(torch.autograd.Function):
    """y = conv3x3(x, weight, bias) on NHWC tensors; saves the input and the
    weight, as ATen's convolution does."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.device.type == "cpu":
            ctx.save_for_backward(x, weight)
            return conv3x3_plain(x, weight, bias)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        x = _dense(x)
        ctx.save_for_backward(x, weight)
        return forward_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        if g.device.type == "cpu":
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight,
                [CHANNELS] if need_b else None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [need_x, need_w, need_b])
            return (None if gx is None else gx.permute(0, 2, 3, 1)), gw, gb
        g = _dense(g)  # once for both kernels
        gx = input_grad_kernel(g, weight) if need_x else None
        gw = gb = None
        if need_w or need_b:
            gw, gb = weight_grad_kernel(x, g)
        return gx, (gw if need_w else None), (gb if need_b else None)


def conv3x3(x, weight, bias=None):
    """3x3 conv, stride 1, padding 1, on NHWC x (B, H, W, 64) with an OIHW
    weight (64, 64, 3, 3) and a bias (64) or None -> NHWC (B, H, W, 64),
    differentiable in all three. A CPU tensor takes the plain version; a
    CUDA tensor runs the kernels (csrc/conv3x3.cu) with no fallback: a
    failed build or launch raises. Overridable by a ``TorchFunctionMode``
    (tools/conv_grads.py records its calls)."""
    if has_torch_function_variadic(x, weight, bias):
        return handle_torch_function(conv3x3, (x, weight, bias), x, weight, bias)
    return _Conv3x3.apply(x, weight, bias)
