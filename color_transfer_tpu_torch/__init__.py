"""color_transfer_tpu_torch — the PyTorch / CUDA port of color_transfer_tpu.

The JAX package beside it (``color_transfer_tpu``) is the reference; every
module here mirrors its counterpart's path and is tested against it on the
CPU (tests/test_torch_port_*.py). This package imports torch and never
jax, flax or the JAX package.

Layout (same paths as the JAX package):
    core/      resize, bilinear sampling and the warp's autograd, blur,
               colour spaces, linalg, precision (plain torch ops)
    ops/       hand-written CUDA kernels and their plain torch versions
    csrc/      CUDA C++ sources of those kernels (built with nvcc at first use)
    metrics/   PSNR, SSIM and the SSIM loss, iCID, FSIM
    data/      distortions, datasets and the threaded loader, the native
               image decoder (ctypes over native/imageio.cc, PIL without it)
    models/    GMFlow matcher, EfficientNet encoder, UNet decoder, DMSCT;
               ResB layers, parallax attention, DCMCS3DI
    methods/   the classical methods; video / batched serving entry point
    run/       modules, trainer, checkpoints, config, logging, data module,
               batch prediction, CLI (fit, validate, test, predict)
    parallel/  data parallelism: torchrun's process group and each rank's
               rows, the train step's collectives, device lists for serving
    tools/     weight bridge from the JAX parameter tree; readers of the
               reference's Lightning checkpoints and unimatch's GMFlow;
               the parity sweep; the drift gate; the training convs'
               float64 check; kernel A/B timing; the offline dataset tool
               (postprocess)
    utils/     image panels, flow colouring, profiling (torch.profiler)

Public functions keep the JAX package's channel-last (NHWC) layout; the
convolutions inside the modules run on permuted (channels-last) views.

Slices ported so far: DMSCT f32 inference (``predict --method dmsct``);
DCMCS3DI inference in f32 and bf16 (``predict --method dcmcs3di``, and the
kernel route of ``models/dcmcs3di.py`` for 1080p); the classical methods;
DMSCT and DCMCS3DI training (``fit`` / ``validate``) with image panels and
profiling, data parallel under torchrun; the evaluation (``test``) and the
parity sweep on the reference's checkpoints; serving split over a device
list; the offline dataset tool. Entry points run on the card unless given ``device="cpu"``
(``--device cpu``).
"""

__version__ = "0.1.0"
