"""True float32 on the card: TF32 off for cuBLAS matmuls and cuDNN convs.

PyTorch runs float32 matmuls in full f32 by default but float32 convs
through cuDNN in TF32; either default can be changed process-wide by a
caller. The JAX package computes its f32 paths at HIGHEST precision, so
the port's f32 inference runs under ``full_f32_inference`` and its training
under ``full_f32``: both set the two flags off and give the caller's
settings back afterwards.
"""

import contextlib

import torch


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
