"""DMSCT and DCMCS3DI modules — port of color_transfer_tpu/run/modules.py:
``DMSCTModule`` whole (the model, its variables, the inference forward,
and training: AdamW with a per-step cosine schedule, the frozen matcher,
MSE + 0.1 SSIM, the reference's quality metrics) and the eval half of
``DCMCS3DIModule``.

Variables are a state_dict (name -> tensor), the counterpart of the JAX
``{"params", "batch_stats"}`` tree: ``init_eval_variables`` makes seeded
random ones, ``tools/convert.py`` (``dmsct_state_dict_from_jax``,
``dcmcs3di_state_dict_from_jax``) converts JAX ones, and ``eval_forward``
runs the model on them through ``torch.func.functional_call`` (the analogue
of flax's ``apply``), so one module serves any set of weights without
copying them into it.

Training state (``TrainState``): the variables (trainable parameters as
leaf tensors that require grad, the matcher's without, the BatchNorm
buffers), the optimizer over the trainable ones, and the count of updates
applied. ``train_step`` mutates it in place: the optimizer steps the
parameters, the encoder's BatchNorm moves its running statistics.
Randomness (the distorted targets, drop-connect) comes from generators
seeded with the integer the trainer passes per step; the JAX package draws
from ``jax.random`` keys, which torch cannot reproduce.
"""

import dataclasses
import math

import torch

from color_transfer_tpu_torch import metrics as M
from color_transfer_tpu_torch.core.precision import full_f32, full_f32_inference
from color_transfer_tpu_torch.data.distortions import apply_uniform_distortions
from color_transfer_tpu_torch.methods.video import resolve_device
from color_transfer_tpu_torch.models.dcmcs3di import DCMCS3DI
from color_transfer_tpu_torch.models.dmsct import DMSCT, compute_losses
from color_transfer_tpu_torch.models.layers import init_uniform_


def quality_metrics(out, gt, prefix="", heavy=True):
    """The reference's four quality metrics under its metric names
    (reference methods/dcmcs3di.py:87-90); 0-d tensors."""
    vals = {
        f"{prefix}PSNR": M.psnr(out, gt),
        f"{prefix}SSIM": M.ssim(out, gt),
        f"{prefix}iCID": M.icid(out, gt),
    }
    if heavy:
        vals[f"{prefix}FSIM"] = M.fsim(out, gt)
    return vals


def cosine_decay(init_value, decay_steps, alpha, count):
    """optax.cosine_decay_schedule in closed form, evaluated at the update
    count (0 for the first update)."""
    t = min(count, decay_steps)
    return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
                         + alpha)


@dataclasses.dataclass
class TrainState:
    """variables: name -> tensor, the model's state_dict layout;
    optimizer: over the trainable variables; step: updates applied (optax's
    count); decay_steps: the cosine schedule's length."""

    variables: dict
    optimizer: torch.optim.Optimizer
    step: int = 0
    decay_steps: int = 10_000


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
    """The reference authors' method: frozen GMFlow matcher + trainable
    EfficientNet/UNet corrector; AdamW(3e-4, weight decay 0.01) with a
    per-step cosine schedule to 1e-6 and MSE + 0.1 SSIM loss (reference
    methods/dmsct.py:118-131, :186-195). The matcher's parameters stay out
    of the optimizer and never require grad (the JAX package masks them
    with ``set_to_zero``)."""

    name = "dmsct"

    def __init__(self, encoder_name="efficientnet-b2", encoder_depth=4,
                 encoder_weights=None, decoder_channels=(256, 128, 64, 32),
                 learning_rate=3e-4, eta_min=1e-6, weight_decay=0.01,
                 heavy_metrics=True, matcher_checkpoint=None,
                 matcher_num_layers=6, matcher_num_reg_refine=6,
                 matcher_fused_attention="auto"):
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
            matcher_fused_attention=matcher_fused_attention,
        ).eval()
        self.learning_rate = learning_rate
        self.eta_min = eta_min
        self.weight_decay = weight_decay
        self.heavy_metrics = heavy_metrics
        self.matcher_checkpoint = matcher_checkpoint
        self.hparams = {
            "encoder_name": encoder_name,
            "encoder_depth": encoder_depth,
            "decoder_channels": list(decoder_channels),
            "learning_rate": learning_rate,
            "matcher_num_layers": matcher_num_layers,
            "matcher_num_reg_refine": matcher_num_reg_refine,
            "matcher_fused_attention": matcher_fused_attention,
        }

    # -- training --

    def init_state(self, seed, sample_batch, num_train_steps=None):
        """Seeded random variables (``random_state_dict``) on the sample
        batch's device, the matcher's from ``matcher_checkpoint`` when set
        (a port state_dict saved with torch.save, with or without the
        ``matcher.`` prefix), and AdamW over every trainable parameter
        (biases and BatchNorm scales included, as optax.adamw)."""
        device = sample_batch["gt"].device
        variables = {k: v.to(device) for k, v in
                     random_state_dict(self.model, seed).items()}
        if self.matcher_checkpoint is not None:
            sd = torch.load(self.matcher_checkpoint, map_location=device)
            for key, value in sd.items():
                name = key if key.startswith("matcher.") else f"matcher.{key}"
                if name not in variables:
                    raise KeyError(f"{self.matcher_checkpoint}: unknown matcher key {key!r}")
                variables[name].copy_(value)
        params = {name for name, _ in self.model.named_parameters()}
        trainable = []
        for name, value in variables.items():
            if name in params and not name.startswith("matcher."):
                value.requires_grad_(True)
                trainable.append(value)
        optimizer = torch.optim.AdamW(
            trainable, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )
        return TrainState(variables, optimizer, 0, num_train_steps or 10_000)

    def synthesize_targets(self, batch, generator):
        """Per-sample random distortion of the gt view; the permutations and
        factors come from ``generator`` (a CPU one)."""
        target = torch.stack([apply_uniform_distortions(img, generator)
                              for img in batch["gt"]])
        return {**batch, "target": target}

    def forward_loss(self, state, batch, generator=None):
        """The train-mode forward and the losses -> (result, total, parts)."""
        result = torch.func.functional_call(
            self.model, state.variables, (batch["target"], batch["reference"]),
            {"train": True, "generator": generator}, strict=True,
        )
        total, parts = compute_losses(result, batch["gt"])
        return result, total, parts

    def apply_gradients(self, state):
        """One AdamW update at the schedule's value for this update, then
        the count moves on."""
        lr = cosine_decay(self.learning_rate, state.decay_steps,
                          self.eta_min / self.learning_rate, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    def train_step(self, state, batch, seed, metrics=True):
        """One update on ``batch`` ({'gt', 'reference'} (B, H, W, 3) on the
        state's device): distort the gt into the target (a CPU generator
        seeded with ``seed``), forward with drop-connect (a generator on the
        device, the same seed), backward, AdamW; TF32 off throughout.
        Returns (state, logs) with the JAX package's metric names; the
        quality metrics only when ``metrics`` (the trainer's log steps)."""
        device = batch["gt"].device
        with full_f32():
            batch = self.synthesize_targets(batch, torch.Generator().manual_seed(seed))
            drop = torch.Generator(device=device).manual_seed(seed)
            result, total, parts = self.forward_loss(state, batch, drop)
            # The backward runs through cuDNN, the decoder's included: only
            # the decoder's forward leaves cuDNN (models/dmsct.py), whose
            # backward at this shape is the faster route (chip_smoke.py
            # phase 7 times both).
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic, allow_tf32=False):
                total.backward()
            self.apply_gradients(state)
            logs = {f"Training {k}": v.detach() for k, v in parts.items()}
            if metrics:
                with torch.no_grad():
                    logs.update(quality_metrics(result.detach(), batch["gt"], "Training ",
                                                self.heavy_metrics))
            logs["Training Total Loss"] = total.detach()
        return state, logs

    def val_step(self, state, batch):
        """Losses and quality metrics of the eval forward on a batch that
        carries its target."""
        with full_f32_inference():
            result = torch.func.functional_call(
                self.model, state.variables, (batch["target"], batch["reference"]),
                strict=True,
            )
            _, parts = compute_losses(result, batch["gt"])
            logs = dict(parts)
            logs.update(quality_metrics(result, batch["gt"], "", self.heavy_metrics))
        return logs

    # -- inference --

    def init_eval_variables(self, seed=0, device=None):
        """Seeded random variables on ``device`` (see random_state_dict);
        None means the card (methods/video.py::resolve_device: raises
        without one; pass "cpu" for the CPU)."""
        device = resolve_device(device)
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

    def init_eval_variables(self, seed=0, device=None):
        """Seeded random variables on ``device`` (None: the card, as in
        DMSCTModule.init_eval_variables): the JAX package's init,
        U(+-1/sqrt(fan_in)) for every conv's kernel and bias, drawn in
        state_dict order from a torch.Generator (JAX's own stream cannot be
        reproduced; tests hand both packages one set of weights through the
        bridge)."""
        device = resolve_device(device)
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
