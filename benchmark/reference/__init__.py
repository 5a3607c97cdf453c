"""Plain PyTorch references of the benchmark's configurations.

A frozen copy of the models' mathematics in float32, written with plain
torch operations only: no hand-written kernel, no process group, no
reduced-precision knob. It imports nothing of the measured package and
nothing of JAX, and takes nothing the measured package made: the benchmark
draws the weights and the inputs from the seed and hands the same ones to
both sides.

``precision(tf32, cudnn)`` runs a block with TF32 off (the
configurations' float32) or on (the control, the precision one step below),
its convolutions on cuDNN or on ATen.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32=False, cudnn=True):
    """cuBLAS and cuDNN in float32 (``tf32`` False) or TF32 for the block,
    the convolutions on cuDNN (``cudnn``) or on ATen (im2col + GEMM); the
    caller's flags come back afterwards. The flags are process-wide, so a
    backward inside the block takes them too."""
    matmul, flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = matmul.allow_tf32
    matmul.allow_tf32 = bool(tf32)
    try:
        with flags.flags(enabled=cudnn, benchmark=flags.benchmark,
                         deterministic=flags.deterministic, allow_tf32=bool(tf32)):
            yield
    finally:
        matmul.allow_tf32 = before


def without_cudnn(fn, *args):
    """``fn(*args)`` through ATen's convolutions (im2col + GEMM) instead of
    cuDNN, whose float32 algorithms are slow at some shapes of these models
    (the GRU's 3x3 convs over 256 channels) or far from float64 (DCMCS3DI's
    training convs). TF32 follows ``precision``."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=cudnn.allow_tf32):
        return fn(*args)
