"""True float32 on the card: TF32 off for cuBLAS matmuls and cuDNN convs.

PyTorch runs float32 matmuls in full f32 by default but float32 convs
through cuDNN in TF32; either default can be changed process-wide by a
caller. The JAX package computes its f32 paths at HIGHEST precision, so
the port's f32 inference runs under ``full_f32_inference`` and its training
under ``full_f32``: both set the two flags off and give the caller's
settings back afterwards.

``conv_route`` picks the convolutions' backend for a block, process-wide;
``reduced_conv_route`` picks it for the reduced-precision (bf16) convs
alone, forward and backward (``routed_conv2d``), so a bf16 training recipe
can keep its f32 convs on one backend and its bf16 convs on another.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN and cuBLAS, and cuBLAS's bf16 products summed in
    f32 (no reduced-precision split-K reduction: the bf16 recipes' sums are
    f32, as the JAX package's); autograd as the caller has it (the training
    context). Also a decorator: ``@full_f32()``."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    before = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False,
        ):
            yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = before


@contextlib.contextmanager
def full_f32_inference():
    """``no_grad`` with TF32 off for cuDNN and cuBLAS. Also a decorator:
    ``@full_f32_inference()``."""
    with torch.no_grad(), full_f32():
        yield


def conv_route(cudnn):
    """The convolutions' backend for the block: cuDNN (True) or, with cuDNN
    off, ATen's (im2col + cuBLAS GEMMs, the depthwise kernels); TF32 off
    either way. The flags are process-wide, so a backward run inside the
    block takes the route on autograd's device threads too."""
    flags = torch.backends.cudnn
    return flags.flags(enabled=cudnn, benchmark=flags.benchmark,
                       deterministic=flags.deterministic, allow_tf32=False)


_REDUCED_ROUTE = contextvars.ContextVar("color_transfer_tpu_torch_reduced_route",
                                        default=None)


def current_reduced_route():
    """The route ``reduced_conv_route`` set (True, False), or None."""
    return _REDUCED_ROUTE.get()


@contextlib.contextmanager
def reduced_conv_route(cudnn):
    """``routed_conv2d`` calls inside run forward and backward through cuDNN
    (True) or ATen (False), whatever the process-wide route is; None: as
    the process's flags say."""
    token = _REDUCED_ROUTE.set(None if cudnn is None else bool(cudnn))
    try:
        yield
    finally:
        _REDUCED_ROUTE.reset(token)


class _RoutedConv(torch.autograd.Function):
    """A stride-1, bias-free conv whose forward and backward both run with
    cuDNN on or off as its call's route says."""

    @staticmethod
    def forward(ctx, x, weight, padding, cudnn):
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.cudnn = padding, cudnn
        with conv_route(cudnn):
            return F.conv2d(x, weight, None, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with conv_route(ctx.cudnn):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, [1, 1], list(ctx.padding), [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def routed_conv2d(x, weight, padding):
    """F.conv2d (NCHW, stride 1, no bias) on the route ``reduced_conv_route``
    set, or as the process's flags say outside one."""
    cudnn = _REDUCED_ROUTE.get()
    if cudnn is None:
        return F.conv2d(x, weight, None, padding=padding)
    return _RoutedConv.apply(x, weight, tuple(padding), cudnn)
