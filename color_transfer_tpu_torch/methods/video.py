"""Video / batched serving — the deep branch of
color_transfer_tpu/methods/video.py's ``color_transfer_between_videos``.

Frames are independent work items: the clip runs in chunks of
``batch_size`` frames through the module's ``eval_forward`` on one device.
The classical methods and DCMCS3DI are not ported yet.
"""

import numpy as np
import torch

DEEP_METHODS = ("dmsct",)


def default_device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def build_deep(method, module=None, variables=None, module_kwargs=None,
               ckpt_path=None, device="cpu"):
    """Resolve (module, variables) for a deep method: prebuilt > random init
    (seed 0). Raises NotImplementedError for what is not ported yet."""
    if method not in DEEP_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported to the torch package yet "
            f"(ported: {', '.join(DEEP_METHODS)})"
        )
    if ckpt_path is not None:
        raise NotImplementedError(
            "ckpt_path: restoring the JAX package's orbax checkpoints is not "
            "ported yet; convert the variables with "
            "tools/convert.dmsct_state_dict_from_jax and pass variables="
        )
    if module is None:
        from color_transfer_tpu_torch.run.modules import DMSCTModule

        module = DMSCTModule(**dict(module_kwargs or {}))
    if variables is None:
        variables = module.init_eval_variables(seed=0, device=device)
    return module, variables


def color_transfer_between_videos(target_frames, reference_frames,
                                  method="dmsct", batch_size=None, device=None,
                                  ckpt_path=None, module=None, variables=None,
                                  module_kwargs=None):
    """Transfer colour from reference_frames onto target_frames.

    Args:
      target_frames / reference_frames: (T, H, W, 3) float arrays or tensors
        in [0, 1].
      method: "dmsct" (the only ported method).
      batch_size: frames per forward; None means 1, the per-device default
        of the JAX package's deep serving.
      device: where the model runs; None picks CUDA when available. Given
        ``variables`` run on their own device.
      ckpt_path / module / variables / module_kwargs: where the weights come
        from (see build_deep).

    Returns (T, H, W, 3) corrected frames, a float32 tensor on the device.
    """
    if variables is not None:
        device = next(iter(variables.values())).device
    device = torch.device(device or default_device())
    module, variables = build_deep(method, module, variables, module_kwargs,
                                   ckpt_path, device)
    batch_size = batch_size or 1

    def as_tensor(frames):
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        return frames.to(device=device, dtype=torch.float32)

    outputs = []
    for start in range(0, target_frames.shape[0], batch_size):
        batch = {
            "target": as_tensor(target_frames[start : start + batch_size]),
            "reference": as_tensor(reference_frames[start : start + batch_size]),
        }
        outputs.append(module.eval_forward(variables, batch))
    return torch.cat(outputs, dim=0)
