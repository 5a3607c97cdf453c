"""color_transfer_tpu_torch — the PyTorch / CUDA port of color_transfer_tpu.

The JAX package beside it (``color_transfer_tpu``) is the reference; every
module here mirrors its counterpart's path and is tested against it on the
CPU (tests/test_torch_port_*.py). This package imports torch and never
jax, flax or the JAX package.

Layout (same paths as the JAX package):
    core/      resize and bilinear sampling (plain torch ops)
    ops/       hand-written CUDA kernels and their plain torch versions
    csrc/      CUDA C++ sources of those kernels (built with nvcc at first use)
    models/    GMFlow matcher, EfficientNet encoder, UNet decoder, DMSCT
    methods/   video / batched serving entry point
    run/       DMSCT module, batch prediction, CLI
    tools/     weight bridge from the JAX parameter tree

Public functions keep the JAX package's channel-last (NHWC) layout; the
convolutions inside the modules run on permuted (channels-last) views.

Slice ported so far: DMSCT f32 inference (``predict --method dmsct``).
"""

__version__ = "0.1.0"
