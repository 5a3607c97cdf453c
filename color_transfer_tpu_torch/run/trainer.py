"""Training and validation loops — port of color_transfer_tpu/run/trainer.py
(``fit`` and ``validate``) on one device.

``fit`` builds the module's train state, resumes from a checkpoint at the
epoch after the saved one, runs ``module.train_step`` over the train loader
(metrics logged every ``log_every`` steps, under the JAX package's names),
validates every ``val_every`` epochs and saves ``last`` and, gated on the
monitored metric, ``best``. Each step's randomness is an integer drawn from
``(seed, step)`` (the JAX package folds the step into its key); validation
targets from ``(seed + 1, batch index)``.
"""

import time
from pathlib import Path

import numpy as np
import torch

from color_transfer_tpu_torch.methods.video import resolve_device
from color_transfer_tpu_torch.run.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_train_state,
    train_state_payload,
)
from color_transfer_tpu_torch.run.datamodule import to_float
from color_transfer_tpu_torch.run.logging import MeanAccumulator, MetricLogger


def derive_seed(*entropy):
    """A 31-bit generator seed from integers, e.g. (seed, step)."""
    return int(np.random.SeedSequence(entropy).generate_state(1)[0] >> 1)


class Trainer:
    def __init__(self, max_epochs=100, log_dir="runs/default", log_every=50, seed=42,
                 monitor="Validation PSNR/dataloader_idx_0", use_wandb=False,
                 val_every=1, device=None):
        self.max_epochs = max_epochs
        self.log_dir = Path(log_dir)
        self.log_every = log_every
        self.seed = seed
        self.val_every = val_every
        self.device = resolve_device(device)
        self.logger = MetricLogger(self.log_dir, use_wandb=use_wandb)
        self.ckpt = CheckpointManager(self.log_dir / "checkpoints", monitor=monitor)

    def device_batch(self, batch):
        """A loader batch as float32 tensors in [0, 1] on the device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in to_float(batch).items() if k != "distortion_idx"}

    def fit(self, module, datamodule, resume=None):
        train_loader = datamodule.train_loader()
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

        step = state.step
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.time()
            for batch in train_loader:
                log_now = step % self.log_every == 0
                state, logs = module.train_step(state, self.device_batch(batch),
                                                derive_seed(self.seed, step), metrics=log_now)
                if log_now:
                    self.logger.log({k: float(v) for k, v in logs.items()}, step=step)
                step += 1
            self.logger.log({"epoch": epoch, "epoch_time": time.time() - t0}, step=step)

            if (epoch + 1) % self.val_every == 0:
                val_metrics = self.validate(module, datamodule, state, step)
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
        return state

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
                    batch = module.synthesize_targets(batch, gen)
                logs = module.val_step(state, batch)
                acc.update({k: float(v) for k, v in logs.items()})
            all_metrics.update({f"Validation {k}/dataloader_idx_{idx}": v
                                for k, v in acc.means().items()})
        if all_metrics:
            self.logger.log(all_metrics, step=step)
        return all_metrics
