"""Video / batched serving — port of color_transfer_tpu/methods/video.py's
``color_transfer_between_videos``, on one device or split over several.

Frames are independent work items: the clip runs in chunks of
``batch_size`` frames, each chunk split over a list of devices (one
process drives every card, as the JAX package's mesh does). A classical
method (any name of ``methods``' registry) runs each piece through its
batched form, which the JAX package gets from ``jax.vmap``; its output is
clipped to [0, 1]. Two statistics modes, as in the JAX package:
  * per_frame (default): each frame matched against its own reference
    frame;
  * global: every frame matched against reference frame 0 (temporally
    stable for the global/linear methods).
A deep method ("dcmcs3di", "dmsct") runs each piece through its module's
``eval_forward``.
"""

import itertools

import numpy as np
import torch

from color_transfer_tpu_torch import methods
from color_transfer_tpu_torch.core.precision import full_f32_inference
from color_transfer_tpu_torch.parallel.mesh import (
    create_mesh,
    pad_to_devices,
    replicate,
    shard_batch,
)
from color_transfer_tpu_torch.utils import profiling

DEEP_METHODS = ("dcmcs3di", "dmsct")
_calls = itertools.count()  # the unit of each call's span


def default_device():
    """The port's entry points run on the card unless told otherwise."""
    return "cuda"


def resolve_device(device=None):
    """``device`` (default: the card) as a torch.device; raises when it is
    the card and there is none, rather than running on the CPU."""
    device = torch.device(device or default_device())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (--device cpu on the command "
            "line) to run on the CPU"
        )
    return device


def build_deep(method, module=None, variables=None, module_kwargs=None,
               ckpt_path=None, device=None):
    """Resolve (module, variables) for a deep method: prebuilt > restored
    from ``ckpt_path`` (a checkpoint directory the port's trainer wrote,
    run/checkpoint.py) > random init (seed 0). Restored or drawn variables
    go to ``device``; None means the card (resolve_device)."""
    if method not in DEEP_METHODS:
        raise ValueError(f"{method!r} is not a deep method ({', '.join(DEEP_METHODS)})")
    if module is None:
        from color_transfer_tpu_torch.run import modules

        cls = {"dcmcs3di": modules.DCMCS3DIModule,
               "dmsct": modules.DMSCTModule}[method]
        module = cls(**dict(module_kwargs or {}))
    if variables is None and ckpt_path is not None:
        from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables

        variables = restore_eval_variables(module, ckpt_path, device)
    if variables is None:
        variables = module.init_eval_variables(seed=0, device=device)
    return module, variables


def color_transfer_between_videos(target_frames, reference_frames,
                                  method="monge_kantorovitch", batch_size=None,
                                  device=None, per_frame=True, ckpt_path=None,
                                  module=None, variables=None, module_kwargs=None,
                                  allow_ungated=False, devices=None):
    """Transfer colour from reference_frames onto target_frames.

    Args:
      target_frames / reference_frames: (T, H, W, 3) float arrays or tensors
        in [0, 1].
      method: a registry name (``methods.available_methods()``) or a deep
        method, "dmsct" or "dcmcs3di".
      batch_size: frames per chunk; None means 8 per device for the
        classical methods and 1 per device for the deep ones, the JAX
        package's defaults. A chunk is split evenly over ``devices`` (cut
        to a multiple of their number, at least one frame each).
      device: one device for every chunk (today's single-device call);
        given ``variables`` run on their own device.
      devices: the devices each chunk is split over (the JAX package's
        ``mesh``; parallel/mesh.py), e.g. ["cuda:0", "cuda:1"]; a list may
        name a device twice. None means every visible card, unless
        ``device`` or ``variables`` name one. The deep variables are copied
        to each device once; a ragged last chunk is padded by repeating its
        last frame, and the padding cut off again; each chunk's pieces are
        launched on every device before any result is read.
      per_frame: classical methods only; False matches every frame against
        reference frame 0.
      ckpt_path / module / variables / module_kwargs: deep methods only —
        where the weights come from (see build_deep); the classical methods
        have no parameters and ignore them.
      allow_ungated: acknowledge serving a recipe whose recorded gate
        verdict is FAIL (methods/gates.py); otherwise a warning names the
        measured drift.

    Returns (T, H, W, 3) corrected frames, a float32 tensor on the (first)
    device.
    """
    with profiling.annotate("video.call", unit=next(_calls)):
        deep = method in DEEP_METHODS
        if deep and variables is not None and devices is None:
            device = next(iter(variables.values())).device
        devices = create_mesh([device] if devices is None and device is not None else devices)
        n_dev = len(devices)
        batch_size = batch_size or (1 if deep else 8) * n_dev
        batch_size = max(batch_size - batch_size % n_dev, n_dev)

        def as_tensor(frames):
            if isinstance(frames, np.ndarray):
                frames = torch.from_numpy(frames)
            return frames.to(dtype=torch.float32)

        r0 = None  # the fixed reference of global mode
        if deep:
            from color_transfer_tpu_torch.methods.gates import check_recipe

            check_recipe(method, module_kwargs, allow_ungated=allow_ungated)
            module, variables = build_deep(method, module, variables, module_kwargs,
                                           ckpt_path, devices[0])
            replicas = replicate(variables, devices)

            def run(i, t, r):
                return module.eval_forward(replicas[i], {"target": t, "reference": r})
        else:
            fn = methods.get_method(method)
            batched = getattr(fn, "batched", None)
            if not per_frame:
                r0 = as_tensor(reference_frames[:1])

            def run(i, t, r):
                with full_f32_inference():
                    if batched is not None:
                        out = batched(t, r)
                    else:
                        r = r.expand(t.shape[0], *r.shape[1:])
                        out = torch.stack([fn(t[i], r[i]) for i in range(t.shape[0])])
                return out.clamp(0.0, 1.0)

        outputs = []
        for start in range(0, target_frames.shape[0], batch_size):
            with profiling.annotate("video.copy_in"):
                t, actual = pad_to_devices(as_tensor(target_frames[start:start + batch_size]), n_dev)
                chunk = {"t": t}
                if r0 is None:
                    chunk["r"] = pad_to_devices(
                        as_tensor(reference_frames[start:start + batch_size]), n_dev)[0]
                pieces = shard_batch(chunk, devices)
            # Every device's piece is launched before any result is read; in
            # global mode every piece runs against reference frame 0.
            with profiling.annotate("video.forward"):
                outs = [run(i, p["t"], p["r"] if r0 is None else r0.to(devices[i]))
                        for i, p in enumerate(pieces)]
            outputs.append(torch.cat([o.to(devices[0]) for o in outs], dim=0)[:actual])
        return torch.cat(outputs, dim=0)
