"""Training and evaluation loops — port of color_transfer_tpu/run/trainer.py
(``fit``, ``validate`` and ``test``) on one device.

``fit`` builds the module's train state, resumes from a checkpoint at the
epoch after the saved one, runs ``module.train_step`` over the train loader
(metrics logged every ``log_every`` steps, under the JAX package's names),
validates every ``val_every`` epochs and saves ``last`` and, gated on the
monitored metric, ``best``. A module with ``image_panels`` gets the
reference's best-PSNR-gated panels: after an epoch whose last step's
training PSNR beats the best so far, and per validation split whose PSNR
does (PNGs under ``log_dir/images``; a failing panel writes
``image_log_error.txt`` and does not stop the run). ``profile_dir`` traces
steps ``profile_steps`` of the fit (utils/profiling.py). Each step's
randomness is an integer drawn from ``(seed, step)`` (the JAX package
folds the step into its key); validation targets from ``(seed + 1, batch
index)``, panel targets from ``(seed, 2**31)`` and ``(seed + 2, split)``. ``test`` is the paper's
evaluation: every item of the test loaders through the module's
``eval_forward`` and the four quality metrics, the artificial set's items
distorted by their grid distortion.

Data parallelism (parallel/): under a process group (torchrun) each rank
runs on its card (``cuda:{LOCAL_RANK}``, or the ``device`` given), loads
its rows of every global batch, and takes the global batch's step (the
modules average over the ranks). Rank 0 alone writes the metrics, the
checkpoints, the panels and the profile, and validates unsharded, as the
JAX package validates (``sharded=False``); the other ranks wait at a
barrier. Every rank resumes from the checkpoint.
"""

import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

from color_transfer_tpu_torch.data.distortions import distort_batch, setup_grid_distortions
from color_transfer_tpu_torch.parallel.data_parallel import barrier, broadcast_variables
from color_transfer_tpu_torch.parallel.multihost import local_device, rank_world
from color_transfer_tpu_torch.run.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_train_state,
    train_state_payload,
)
from color_transfer_tpu_torch.run.datamodule import to_float
from color_transfer_tpu_torch.run.logging import MeanAccumulator, MetricLogger
from color_transfer_tpu_torch.utils import profiling


def derive_seed(*entropy):
    """A 31-bit generator seed from integers, e.g. (seed, step)."""
    return int(np.random.SeedSequence(entropy).generate_state(1)[0] >> 1)


class _SilentLogger:
    """The logger of a rank other than 0: writes nothing."""

    def log(self, *args, **kwargs):
        pass

    log_image = log_checkpoint = log


class Trainer:
    def __init__(self, max_epochs=100, log_dir="runs/default", log_every=50, seed=42,
                 monitor="Validation PSNR/dataloader_idx_0", use_wandb=False,
                 val_every=1, device=None, profile_dir=None, profile_steps=(10, 15)):
        self.max_epochs = max_epochs
        self.log_dir = Path(log_dir)
        self.log_every = log_every
        self.seed = seed
        self.val_every = val_every
        self.device = local_device(device)
        self.rank, self.world = rank_world()
        self.is_main = self.rank == 0
        if self.is_main:
            self.logger = MetricLogger(self.log_dir, use_wandb=use_wandb)
            self.ckpt = CheckpointManager(self.log_dir / "checkpoints", monitor=monitor)
        else:
            self.logger, self.ckpt = _SilentLogger(), None
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)

    def device_batch(self, batch):
        """A loader batch as float32 tensors in [0, 1] on the device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in to_float(batch).items() if k != "distortion_idx"}

    def fit(self, module, datamodule, resume=None):
        train_loader = datamodule.train_loader(self.rank, self.world)
        steps_per_epoch = len(train_loader)
        sample = self.device_batch(train_loader.first_batch())
        state = module.init_state(self.seed, sample, steps_per_epoch * self.max_epochs)

        start_epoch = 0
        if resume is not None:
            payload, meta = load_checkpoint(resume, self.device)
            load_train_state(state, payload)
            # Continue after the saved epoch (Lightning's --ckpt_path), with
            # the loader's shuffle and crop streams where an uninterrupted
            # run would be.
            if meta.get("epoch") is not None:
                start_epoch = int(meta["epoch"]) + 1
            else:
                start_epoch = state.step // max(steps_per_epoch, 1)
            train_loader.set_epoch(start_epoch)
        if self.world > 1:
            broadcast_variables(state.variables)  # every rank starts from rank 0's

        step = state.step
        max_scores = {}
        panels = hasattr(module, "image_panels")
        profiler = None
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            batch, logs = None, {}
            for i, loader_batch in enumerate(train_loader):
                if (self.is_main and self.profile_dir is not None
                        and step == self.profile_steps[0]):
                    profiler = profiling.trace(self.profile_dir)
                    profiler.__enter__()
                log_now = step % self.log_every == 0
                # The epoch's last step also computes the training PSNR
                # that gates the panels.
                batch = self.device_batch(loader_batch)
                state, logs = module.train_step(
                    state, batch, derive_seed(self.seed, step),
                    metrics=log_now or (panels and i == steps_per_epoch - 1))
                if profiler is not None and step == self.profile_steps[1]:
                    profiler = self._stop_profile(profiler)
                if log_now:
                    self.logger.log({k: float(v) for k, v in logs.items()}, step=step)
                step += 1
            train_psnr = float(logs.get("Training PSNR", 0.0))
            if (self.is_main and panels and batch is not None
                    and train_psnr > max_scores.get("Training", 0.0)):
                max_scores["Training"] = train_psnr
                gen = torch.Generator().manual_seed(derive_seed(self.seed, 2**31))
                self._log_panels(module, state, batch, gen, "Training Images", step)
            self.logger.log({"epoch": epoch, "epoch_time": time.time() - t0}, step=step)

            if (epoch + 1) % self.val_every == 0:
                self._end_epoch(module, datamodule, state, epoch, step, max_scores)
        if profiler is not None:  # the fit ended inside the profiled steps
            self._stop_profile(profiler)
        return state

    def _end_epoch(self, module, datamodule, state, epoch, step, max_scores):
        """Rank 0 validates, logs the validation panels and saves ``last``
        and, gated, ``best``; every rank then meets at a barrier."""
        if self.is_main:
            val_metrics = self.validate(module, datamodule, state, step)
            if hasattr(module, "image_panels"):
                self._log_val_panels(module, datamodule, state, val_metrics, max_scores,
                                     step)
            payload = train_state_payload(state)
            self.ckpt.save_last(payload, hparams=module.hparams, step=step, epoch=epoch)
            self.logger.log_checkpoint(self.ckpt.ckpt_dir / "last", "last", step=step)
            if self.ckpt.monitor in val_metrics and self.ckpt.save_best(
                payload, val_metrics, hparams=module.hparams, step=step, epoch=epoch,
            ):
                self.logger.log_checkpoint(
                    self.ckpt.ckpt_dir / "best", "best", step=step,
                    score=float(val_metrics[self.ckpt.monitor]),
                )
        barrier()

    def _stop_profile(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)

    def _log_panels(self, module, state, batch, generator, key, step):
        """``module.image_panels`` of a device batch (its target synthesised
        from ``generator`` when it has none) logged as images under
        ``key``; an error is written to image_log_error.txt instead."""
        try:
            if "target" not in batch:
                batch = module.synthesize_targets(batch, generator)
            panels = module.image_panels(state, batch)
            self.logger.log_image(key, [v.detach().float().cpu().numpy()
                                        for v in panels.values()],
                                  caption=list(panels), step=step)
        except Exception:  # noqa: BLE001 — a panel must not stop a run
            (self.log_dir / "image_log_error.txt").write_text(traceback.format_exc())
            self.logger.log({"image_log_error": 1.0}, step=step)

    def _log_val_panels(self, module, datamodule, state, val_metrics, max_scores, step):
        """Panels of each validation split's first batch whose PSNR beats the
        split's best so far (the reference keeps one best per prefix)."""
        for idx, loader in enumerate(datamodule.val_loaders()):
            split = f"Validation/dataloader_idx_{idx}"
            psnr = val_metrics.get(f"Validation PSNR/dataloader_idx_{idx}")
            if psnr is None or psnr <= max_scores.get(split, 0.0):
                continue
            max_scores[split] = psnr
            gen = torch.Generator().manual_seed(derive_seed(self.seed + 2, idx))
            self._log_panels(module, state, self.device_batch(loader.first_batch()), gen,
                             f"Validation Images/dataloader_idx_{idx}", step)

    def validate(self, module, datamodule, state, step, max_batches=None):
        """Mean losses and metrics of each validation loader, logged as
        "Validation {name}/dataloader_idx_{i}"."""
        all_metrics = {}
        for idx, loader in enumerate(datamodule.val_loaders()):
            acc = MeanAccumulator()
            for b_i, batch in enumerate(loader):
                if max_batches is not None and b_i >= max_batches:
                    break
                batch = self.device_batch(batch)
                if "target" not in batch:
                    # The artificial set: distort the gt as training does.
                    gen = torch.Generator().manual_seed(derive_seed(self.seed + 1, b_i))
                    batch = {**batch, "target": distort_batch(batch["gt"], gen)}
                logs = module.val_step(state, batch)
                acc.update({k: float(v) for k, v in logs.items()})
            all_metrics.update({f"Validation {k}/dataloader_idx_{idx}": v
                                for k, v in acc.means().items()})
        if all_metrics:
            self.logger.log(all_metrics, step=step)
        return all_metrics

    def test(self, module, datamodule, variables=None, max_batches=None,
             eval_buckets=None):
        """The evaluation sweep (the reference's ``test``,
        methods/__init__.py:29-40): mean PSNR, SSIM, iCID and FSIM of each
        test loader, logged at step 0 as "Test {metric}/dataloader_idx_{i}".
        A deep module without ``variables`` runs from the seed's random
        init, as the reference does without a checkpoint.

        ``eval_buckets``: pad each item to a multiple of it and score the
        true region (run/bucketing.py); only a module that can mask the
        padded width (``supports_valid_w``) runs so, the others warn and run
        at native shapes. Each item's spans, ``test.data``, ``test.forward``
        and ``test.metrics``, go to the recorder when it is on
        (utils/profiling.py)."""
        grid = setup_grid_distortions()
        if variables is None and hasattr(module, "init_eval_variables"):
            variables = module.init_eval_variables(self.seed, device=self.device)
        bucketed = None
        if eval_buckets:
            if not getattr(module, "supports_valid_w", False):
                # The classical methods' statistics span the whole image:
                # zero padding would pull them towards black.
                warnings.warn(
                    f"--eval_buckets ignored: module '{module.name}' cannot "
                    "mask padded pixels; evaluating at native shapes",
                    stacklevel=2,
                )
            else:
                from color_transfer_tpu_torch.run.bucketing import BucketedEvaluator

                bucketed = BucketedEvaluator(module, multiple=eval_buckets)
        results = {}
        for idx, loader in enumerate(datamodule.test_loaders()):
            acc = MeanAccumulator()
            for b_i, batch in enumerate(loader):
                if max_batches is not None and b_i >= max_batches:
                    break
                with profiling.annotate("test.data"):
                    dist_idx = batch.pop("distortion_idx", None)
                    batch = self.device_batch(batch)
                    if "target" not in batch:
                        # The artificial set: each item's grid distortion.
                        idxs = np.atleast_1d(np.asarray(dist_idx)).tolist()
                        batch["target"] = torch.stack(
                            [grid[int(d)](batch["gt"][j]) for j, d in enumerate(idxs)])
                with profiling.annotate("test.forward"):
                    if bucketed is None:
                        out = module.eval_forward(variables, batch)
                    else:
                        out, padded = bucketed.forward(variables, batch)
                with profiling.annotate("test.metrics"), torch.no_grad():
                    if bucketed is None:
                        logs = module.eval_metrics(out, batch["gt"])
                    else:
                        logs = bucketed.metrics(out, padded["gt"], batch["gt"].shape[1:3])
                    acc.update({k: float(v) for k, v in logs.items()})
            results.update({f"Test {k}/dataloader_idx_{idx}": v
                            for k, v in acc.means().items()})
        self.logger.log(results, step=0)
        return results
