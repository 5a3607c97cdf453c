"""True float32 on the card: TF32 off for cuBLAS matmuls and cuDNN convs.

PyTorch runs float32 matmuls in full f32 by default but float32 convs
through cuDNN in TF32; either default can be changed process-wide by a
caller. The JAX package computes its f32 paths at HIGHEST precision, so
the port's f32 inference runs under ``full_f32_inference``, which sets both
flags off and gives the caller's settings back afterwards.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32_inference():
    """``no_grad`` with TF32 off for cuDNN and cuBLAS. Also a decorator:
    ``@full_f32_inference()``."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False,
        ):
            yield
    finally:
        matmul.allow_tf32 = before
