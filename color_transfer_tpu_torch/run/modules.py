"""DMSCT and DCMCS3DI modules — the eval halves of
color_transfer_tpu/run/modules.py's ``DMSCTModule`` and
``DCMCS3DIModule``: build the model, make its variables, run the inference
forward.

Variables are a state_dict (name -> tensor), the counterpart of the JAX
``{"params", "batch_stats"}`` tree: ``init_eval_variables`` makes seeded
random ones, ``tools/convert.py`` (``dmsct_state_dict_from_jax``,
``dcmcs3di_state_dict_from_jax``) converts JAX ones, and ``eval_forward``
runs the model on them through ``torch.func.functional_call`` (the analogue
of flax's ``apply``), so one module serves any set of weights without
copying them into it.
"""

import contextlib

import torch

from color_transfer_tpu_torch.models.dcmcs3di import DCMCS3DI
from color_transfer_tpu_torch.models.dmsct import DMSCT
from color_transfer_tpu_torch.models.layers import init_uniform_


@contextlib.contextmanager
def full_f32_inference():
    """``no_grad`` with cuDNN's TF32 convolutions (on by default in
    PyTorch) off; matrix products are f32 by PyTorch's default. The
    caller's cuDNN settings are back afterwards."""
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic, allow_tf32=False,
    ):
        yield


def random_state_dict(model, seed=0):
    """Seeded random variables for ``model`` (float32, CPU): LeCun-normal
    weights (std 1/sqrt(fan_in), the flax default for convs and dense
    layers), zero biases, unit norm scales, BatchNorm running mean 0 / var 1.
    The JAX package's ``init_eval_variables`` draws from jax.random, which
    torch cannot reproduce; tests hand both packages one set of weights
    through the bridge instead."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, ref in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.long)
        elif leaf == "running_var" or (leaf == "weight" and ref.ndim == 1):
            out[name] = torch.ones(ref.shape)
        elif leaf in ("bias", "running_mean"):
            out[name] = torch.zeros(ref.shape)
        else:
            fan_in = ref[0].numel()
            out[name] = torch.randn(ref.shape, generator=g) / fan_in**0.5
    return out


class DMSCTModule:
    """The reference authors' method, inference only: frozen GMFlow matcher
    + EfficientNet/UNet corrector."""

    def __init__(self, encoder_name="efficientnet-b2", encoder_depth=4,
                 encoder_weights=None, decoder_channels=(256, 128, 64, 32),
                 matcher_num_layers=6, matcher_num_reg_refine=6):
        if encoder_weights is not None:  # the reference configs pass null
            raise NotImplementedError(
                f"encoder_weights={encoder_weights!r}: pretrained encoder "
                "weights are not supported; pass null"
            )
        self.model = DMSCT(
            encoder_name=encoder_name,
            encoder_depth=encoder_depth,
            decoder_channels=tuple(decoder_channels),
            matcher_num_layers=matcher_num_layers,
            matcher_num_reg_refine=matcher_num_reg_refine,
        ).eval()

    def init_eval_variables(self, seed=0, device="cpu"):
        """Seeded random variables on ``device`` (see random_state_dict)."""
        return {k: v.to(device) for k, v in
                random_state_dict(self.model, seed).items()}

    def eval_forward(self, variables, batch):
        """batch: {'target', 'reference'} (B, H, W, 3) in [0, 1] on the
        variables' device -> corrected (B, H, W, 3).

        Runs in full float32 (``full_f32_inference``): the GRU refinement
        amplifies TF32 rounding, and only the f32 recipe passes the JAX
        package's drift gate."""
        with full_f32_inference():
            return torch.func.functional_call(
                self.model, variables, (batch["target"], batch["reference"]),
                strict=True,
            )


def _dtype(name):
    """None, a torch dtype or its name ("bfloat16", "float32") -> dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtype


class DCMCS3DIModule:
    """Croci et al. corrector, inference only. ``compute_dtype`` None is
    the float32 recipe; "bfloat16" runs the extraction and transfer convs
    in bf16 with the matcher in float32."""

    def __init__(self, extraction_layers=18, transfer_layers=6, channels=64,
                 compute_dtype=None):
        self.model = DCMCS3DI(
            extraction_layers=extraction_layers,
            transfer_layers=transfer_layers,
            channels=channels,
            compute_dtype=_dtype(compute_dtype),
        ).eval()

    def init_eval_variables(self, seed=0, device="cpu"):
        """Seeded random variables on ``device``: the JAX package's init,
        U(+-1/sqrt(fan_in)) for every conv's kernel and bias, drawn in
        state_dict order from a torch.Generator (JAX's own stream cannot be
        reproduced; tests hand both packages one set of weights through the
        bridge)."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                init_uniform_(mod, g)
        return {k: v.detach().clone().to(device)
                for k, v in self.model.state_dict().items()}

    def eval_forward(self, variables, batch):
        """batch: {'target', 'reference'} (B, H, W, 3) in [0, 1] on the
        variables' device -> corrected (B, H, W, 3).

        The JAX module's call: ``inference=True`` on the materialised
        matcher, no kernel route. cuDNN's TF32 is off for the call
        (``full_f32_inference``), so the float32 recipe and the float32
        matcher of the bf16 recipe compute in full float32."""
        with full_f32_inference():
            out, _ = torch.func.functional_call(
                self.model, variables, (batch["target"], batch["reference"]),
                {"inference": True}, strict=True,
            )
            return out
