"""Method modules — port of color_transfer_tpu/run/modules.py:
``DMSCTModule`` (the model, its variables, the inference forward, and
training: AdamW with a per-step cosine schedule, the frozen matcher, MSE +
0.1 SSIM), ``DCMCS3DIModule`` (Adam, L1 + MSE + SSIM + the PAM losses, on
the chunked or the materialised training matcher) and ``ClassicalModule``
(a registry method under the same evaluation harness). Each logs the
reference's quality metrics under the JAX package's names.

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
import inspect
import math

import torch

from color_transfer_tpu_torch import methods
from color_transfer_tpu_torch import metrics as M
from color_transfer_tpu_torch.core.precision import conv_route, full_f32, full_f32_inference
from color_transfer_tpu_torch.data.distortions import distort_batch
from color_transfer_tpu_torch.methods.iterative import random_rotations
from color_transfer_tpu_torch.methods.video import resolve_device
from color_transfer_tpu_torch.models import dcmcs3di as dc
from color_transfer_tpu_torch.models.dmsct import DMSCT, compute_losses
from color_transfer_tpu_torch.models.layers import init_uniform_
from color_transfer_tpu_torch.run.trainer import derive_seed


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
    # The train step's backward convolutions through cuDNN (True) or ATen.
    # At the recipe's shape every gradient of cuDNN's meets the float64 rule
    # with room (at most 0.2 of its line; tools/conv_grads.py, chip_smoke.py
    # phase 7), and ATen would cost 16-20% of a step.
    backward_cudnn = True

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
        batch's device, the matcher's from ``matcher_checkpoint`` when set,
        and AdamW over every trainable parameter (biases and BatchNorm
        scales included, as optax.adamw). ``matcher_checkpoint`` is a port
        state_dict saved with torch.save (with or without the ``matcher.``
        prefix), unimatch's GMFlow ``.pth`` or the JAX converter's pickle
        (tools/convert_gmflow.py::load_matcher); an unknown key raises."""
        from color_transfer_tpu_torch.tools.convert_gmflow import load_matcher

        device = sample_batch["gt"].device
        variables = {k: v.to(device) for k, v in
                     random_state_dict(self.model, seed).items()}
        if self.matcher_checkpoint is not None:
            for key, value in load_matcher(self.matcher_checkpoint).items():
                name = f"matcher.{key}"
                if name not in variables:
                    raise KeyError(f"{self.matcher_checkpoint}: unknown matcher key {key!r}")
                if variables[name].shape != value.shape:
                    raise ValueError(f"{self.matcher_checkpoint}: {key} is "
                                     f"{tuple(value.shape)}, the matcher has "
                                     f"{tuple(variables[name].shape)}")
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
        return {**batch, "target": distort_batch(batch["gt"], generator)}

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
            # The backward's convolutions take ``backward_cudnn``'s route;
            # only the decoder's forward leaves cuDNN (models/dmsct.py).
            with conv_route(self.backward_cudnn):
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

    def eval_metrics(self, out, gt):
        return quality_metrics(out, gt, "", True)

    def image_panels(self, state, batch):
        """Qualitative panels of the batch's last item (reference
        methods/dmsct.py:148-184): the chess mix of gt and result, the error
        maps, the bidirectional matcher's forward flow, the reference warped
        by it and the forward occlusion. (H, W, 3) tensors in [0, 1]."""
        from color_transfer_tpu_torch.core.sampling import flow_warp
        from color_transfer_tpu_torch.utils import visualizations as viz
        from color_transfer_tpu_torch.utils.flow_viz import flow_batch_to_images

        one = {k: v[-1:] for k, v in batch.items()}
        result = self.eval_forward(state.variables, one)
        matcher = {k[len("matcher."):]: v for k, v in state.variables.items()
                   if k.startswith("matcher.")}
        with full_f32_inference():
            out = torch.func.functional_call(
                self.model.matcher, matcher, (one["target"] * 255.0, one["reference"] * 255.0),
                strict=True)
            flow = out["flow"]
            flow_img = torch.from_numpy(flow_batch_to_images(flow)).to(flow.device).float()
            warped = flow_warp(one["reference"], flow)
            return {
                "Left Ground Truth/Corrected": viz.chess_mix(one["gt"], result)[0],
                "RGB MSE Error": viz.rgbmse(one["gt"], result)[0],
                "RGB SSIM Error": viz.rgbssim(one["gt"], result)[0],
                "Optical Flow": flow_img[0] / 255.0,
                "Warped Right": warped[0],
                "Occlusions": out["fwd_occ"][0].expand(-1, -1, 3),
            }


def _dtype(name):
    """None, a torch dtype or its name ("bfloat16", "float32") -> dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtype


class DCMCS3DIModule:
    """Croci et al. corrector: Adam(1e-4) on L1 + MSE + SSIM + 0.005 x the
    PAM losses (reference methods/dcmcs3di.py:68-92, :146-147).

    ``compute_dtype`` None is the float32 recipe; "bfloat16" runs the
    extraction and transfer convs in bf16 with the matcher in float32, for
    evaluation and serving only. ``fused_attention`` trains through the
    chunked matcher (``attention_chunk`` rows a step; the default, as in the
    JAX package), else through the materialised one: the same loss values
    and gradients. ``remat_convs`` recomputes the ResB stacks in the
    backward."""

    name = "dcmcs3di"
    # The train step's backward convolutions through ATen (cuDNN off): at
    # the recipe's shape cuDNN's weight gradient of the matcher head's
    # channels-last 3x3 conv lies at 0.83 of the float64 rule's line,
    # ATen's every gradient under 0.05 of it, for 27-38% of a step
    # (tools/conv_grads.py; chip_smoke.py phase 10; PERF.md).
    backward_cudnn = False
    # Bucketed evaluation may pass the true width (run/bucketing.py).
    supports_valid_w = True

    def __init__(self, extraction_layers=18, transfer_layers=6, channels=64,
                 learning_rate=1e-4, heavy_metrics=True, fused_attention=True,
                 attention_chunk=8, compute_dtype=None, remat_convs=False):
        self.model = dc.DCMCS3DI(
            extraction_layers=extraction_layers,
            transfer_layers=transfer_layers,
            channels=channels,
            compute_dtype=_dtype(compute_dtype),
            remat_convs=remat_convs,
        ).eval()
        self.learning_rate = learning_rate
        self.heavy_metrics = heavy_metrics
        self.fused_attention = fused_attention
        self.attention_chunk = attention_chunk
        self.hparams = {
            "extraction_layers": extraction_layers,
            "transfer_layers": transfer_layers,
            "channels": channels,
            "learning_rate": learning_rate,
            "fused_attention": fused_attention,
            "compute_dtype": compute_dtype,
            "remat_convs": remat_convs,
        }

    # -- training --

    def init_state(self, seed, sample_batch, num_train_steps=None):
        """``init_eval_variables(seed)`` on the sample batch's device, every
        one a trainable leaf, and Adam over them (optax.adam's defaults)."""
        variables = self.init_eval_variables(seed, device=sample_batch["gt"].device)
        for value in variables.values():
            value.requires_grad_(True)
        optimizer = torch.optim.Adam(list(variables.values()), lr=self.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        return TrainState(variables, optimizer, 0, num_train_steps or 10_000)

    synthesize_targets = DMSCTModule.synthesize_targets

    def forward_loss(self, state, batch):
        """The training forward on the configured matcher and the losses ->
        (corrected, total, parts)."""
        args = (batch["target"], batch["reference"])
        if self.fused_attention:
            corrected, pam = torch.func.functional_call(
                self.model, state.variables, args, {"chunk": self.attention_chunk},
                strict=True)
            total, parts = dc.compute_losses_fused(corrected, pam, batch)
            return corrected, total, parts
        out = torch.func.functional_call(self.model, state.variables, args, strict=True)
        total, parts = dc.compute_losses(out, batch)
        return out[0], total, parts

    def apply_gradients(self, state):
        """One Adam update, then the count moves on."""
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    def train_step(self, state, batch, seed, metrics=True):
        """One Adam update on ``batch`` ({'gt', 'reference'} (B, H, W, 3) on
        the state's device): distort the gt into the target (a CPU generator
        seeded with ``seed``), forward and backward with the convs through
        ATen (``backward_cudnn``), losses, step; TF32 off. Returns (state, logs) under the JAX
        package's names; the quality metrics only when ``metrics``."""
        if self.model.compute_dtype is not None:
            raise NotImplementedError(
                f"DCMCS3DI training in {self.model.compute_dtype}: only float32 "
                "trains; a bf16 training recipe needs its own gate on the card "
                "first (ROADMAP.md, section A)"
            )
        with full_f32():
            batch = self.synthesize_targets(batch, torch.Generator().manual_seed(seed))
            # The forward's convs run through ATen, not cuDNN: with cuDNN's
            # f32 forward algorithms the step's gradients lie up to 1.5e-4 of
            # their scale from a float64 run, with ATen's 1.4e-6; ATen costs
            # 3-10% of a recipe step (chip_smoke.py phase 10, PERF.md).
            with conv_route(False):
                corrected, total, parts = self.forward_loss(state, batch)
            with conv_route(self.backward_cudnn):
                total.backward()
            self.apply_gradients(state)
            logs = {f"Training {k}": v.detach() for k, v in parts.items()}
            if metrics:
                with torch.no_grad():
                    logs.update(quality_metrics(corrected.detach(), batch["gt"], "Training ",
                                                self.heavy_metrics))
            logs["Training Total Loss"] = total.detach()
        return state, logs

    def val_step(self, state, batch):
        """The losses and quality metrics of the materialised forward on a
        batch that carries its target (reference methods/dcmcs3di.py:97-98)."""
        with full_f32_inference():
            out = torch.func.functional_call(
                self.model, state.variables, (batch["target"], batch["reference"]),
                strict=True)
            _, parts = dc.compute_losses(out, batch)
            logs = dict(parts)
            logs.update(quality_metrics(out[0], batch["gt"], "", self.heavy_metrics))
        return logs

    # -- inference --

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

    def eval_forward(self, variables, batch, valid_w=None):
        """batch: {'target', 'reference'} (B, H, W, 3) in [0, 1] on the
        variables' device -> corrected (B, H, W, 3).

        The JAX module's call: ``inference=True`` on the materialised
        matcher, no kernel route; ``valid_w`` masks the columns of a padded
        batch (run/bucketing.py). cuDNN's TF32 is off for the call
        (``full_f32_inference``), so the float32 recipe and the float32
        matcher of the bf16 recipe compute in full float32."""
        with full_f32_inference():
            out, _ = torch.func.functional_call(
                self.model, variables, (batch["target"], batch["reference"]),
                {"inference": True, "valid_w": valid_w}, strict=True,
            )
            return out

    def eval_metrics(self, out, gt):
        return quality_metrics(out, gt, "", True)

    def image_panels(self, state, batch):
        """Qualitative panels of the batch's last item (reference
        methods/dcmcs3di.py:116-144): the chess mix of gt and result, the
        error maps, the regressed disparity (min-max scaled), the reference
        warped by the parallax attention and the occlusion mask, from the
        materialised forward. (H, W, 3) tensors in [0, 1]."""
        from color_transfer_tpu_torch.models import pasm
        from color_transfer_tpu_torch.utils import visualizations as viz

        one = {k: v[-1:] for k, v in batch.items()}
        with full_f32_inference():
            result, (att, _, valid_mask, warped_right) = torch.func.functional_call(
                self.model, state.variables, (one["target"], one["reference"]), strict=True)
            result = result.clamp(0, 1)
            valid = valid_mask[0].float()
            disparity = pasm.regress_disp(att[0], valid)
            disparity = (disparity - disparity.min()) / (disparity.max() - disparity.min()
                                                         + 1e-9)
            return {
                "Left Ground Truth/Corrected": viz.chess_mix(one["gt"], result)[0],
                "RGB MSE Error": viz.rgbmse(one["gt"], result)[0],
                "RGB SSIM Error": viz.rgbssim(one["gt"], result)[0],
                "Disparity": disparity[0].expand(-1, -1, 3),
                "Warped Right": warped_right[0],
                "Occlusions": (1.0 - valid[0]).expand(-1, -1, 3),
            }


class ClassicalModule:
    """A classical registry method under the evaluation harness (reference
    methods/__init__.py:10-40): no parameters, metric-only validation.

    ``func_spec`` is a registry name or a reference dotted path
    (``methods.linear.color_transfer_between_images``). A method that takes
    rotations (IDT, grading) gets fresh ones for every image, as the
    reference draws them from its global RNG: call ``c`` of the module
    draws image j's from a torch.Generator seeded with ``derive_seed(seed,
    c, j)`` (the JAX module splits ``fold_in(PRNGKey(seed), c)`` per image;
    that stream cannot be reproduced)."""

    name = "classical"

    def __init__(self, func_spec="monge_kantorovitch", seed=42):
        self.func_spec = func_spec
        self.seed = seed
        self.fn = methods.get_method(func_spec)
        self.batched = getattr(self.fn, "batched", None)
        params = inspect.signature(self.batched or self.fn).parameters
        self.n_iter = params["n_iter"].default if "rotations" in params else None
        self._call_count = 0
        self.hparams = {"func_spec": func_spec}

    def init_state(self, seed, sample_batch, num_train_steps=None):
        """Parameterless: the harness's state is None."""
        del seed, sample_batch, num_train_steps
        return None

    def draw_rotations(self, batch_size):
        """(batch_size, n_iter, 3, 3) rotations for the next call; None for a
        method that takes none. Advances the call count."""
        if self.n_iter is None:
            return None
        call = self._call_count
        self._call_count += 1
        return torch.stack([
            random_rotations(torch.Generator().manual_seed(derive_seed(self.seed, call, j)),
                             self.n_iter)
            for j in range(batch_size)])

    def val_step(self, state, batch):
        """Metric-only validation (the reference Runner has no losses)."""
        del state
        return self.eval_metrics(self.eval_forward(None, batch), batch["gt"])

    def eval_forward(self, variables, batch, rotations=None):
        """batch: {'target', 'reference'} (B, H, W, 3) -> the method's
        output clipped to [0, 1]. A method that takes rotations runs image
        by image on ``rotations`` (B, n_iter, 3, 3), by default the next
        call's ``draw_rotations``; the others run on the whole batch."""
        del variables
        t, r = batch["target"], batch["reference"]
        if rotations is None:
            rotations = self.draw_rotations(t.shape[0])
        with full_f32_inference():
            if rotations is not None:
                out = torch.stack([self.fn(t[j], r[j], rotations=rotations[j])
                                   for j in range(t.shape[0])])
            elif self.batched is not None:
                out = self.batched(t, r)
            else:
                out = torch.stack([self.fn(t[j], r[j]) for j in range(t.shape[0])])
        return out.clamp(0.0, 1.0)

    def eval_metrics(self, out, gt):
        return quality_metrics(out, gt, "", True)
