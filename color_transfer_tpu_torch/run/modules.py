"""DMSCT module — the eval half of color_transfer_tpu/run/modules.py's
``DMSCTModule``: build the model, make its variables, run the inference
forward.

Variables are a state_dict (name -> tensor), the counterpart of the JAX
``{"params", "batch_stats"}`` tree: ``init_eval_variables`` makes seeded
random ones, ``tools/convert.dmsct_state_dict_from_jax`` converts JAX ones,
and ``eval_forward`` runs the model on them through
``torch.func.functional_call`` (the analogue of flax's ``apply``), so one
module serves any set of weights without copying them into it.
"""

import torch

from color_transfer_tpu_torch.models.dmsct import DMSCT


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

        Runs in full float32: cuDNN's TF32 convolutions (on by default in
        PyTorch) are turned off for the call, because the GRU refinement
        amplifies their rounding and only the f32 recipe passes the JAX
        package's drift gate. Matrix products are f32 by PyTorch's default."""
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False,
        ):
            return torch.func.functional_call(
                self.model, variables, (batch["target"], batch["reference"]),
                strict=True,
            )

