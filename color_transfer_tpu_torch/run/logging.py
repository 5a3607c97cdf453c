"""Metric and image logging — a copy of color_transfer_tpu/run/logging.py
(framework-free; the port keeps its own so that it imports nothing of the
JAX package).

W&B-compatible: if ``wandb`` is importable and enabled, metrics/images go
there with exactly the reference's metric names ("Training PSNR",
"Validation PSNR/dataloader_idx_0", ...; reference methods/dcmcs3di.py:79-90,
configs/dcmcs3di.yaml:26). Otherwise everything lands in a JSONL file —
one record per logging step — plus PNG image panels on disk.
"""

import json
import time
from pathlib import Path

import numpy as np

try:  # wandb is optional
    import wandb as _wandb
except Exception:  # noqa: BLE001
    _wandb = None


class MetricLogger:
    def __init__(self, log_dir, project="color-transfer", use_wandb=False, run_name=None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.jsonl"
        self._file = open(self.path, "a")
        self.wandb_run = None
        if use_wandb and _wandb is not None:
            self.wandb_run = _wandb.init(project=project, name=run_name, dir=str(log_dir))

    def log(self, metrics, step):
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def log_image(self, key, images, caption=None, step=None):
        """Images: list of (H, W, 3) float [0,1] arrays. Saved as PNGs under
        log_dir/images (and to W&B when enabled), mirroring the reference's
        best-PSNR panels (reference methods/dcmcs3di.py:139-144)."""
        from PIL import Image

        img_dir = self.log_dir / "images"
        img_dir.mkdir(exist_ok=True)
        paths = []
        for i, img in enumerate(images):
            arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
            name = f"{key.replace('/', '_').replace(' ', '_')}_{step or 0}_{i}.png"
            Image.fromarray(arr).save(img_dir / name)
            paths.append(img_dir / name)
        if self.wandb_run is not None:
            self.wandb_run.log(
                {key: [_wandb.Image(str(p), caption=c) for p, c in zip(paths, caption or [None] * len(paths))]},
                step=step,
            )

    def log_checkpoint(self, path, alias, step=None, score=None):
        """Register a saved checkpoint as a run artifact (the reference's
        ``WandbLogger(log_model=true)`` uploads every ModelCheckpoint save
        as a W&B model artifact, configs/dcmcs3di.yaml:19-22). With W&B
        active the checkpoint directory is uploaded under the run's model
        artifact with the given alias ("best"/"last"); offline, the event
        lands in metrics.jsonl so artifact lineage stays observable."""
        record = {"checkpoint": str(path), "alias": alias, "time": time.time()}
        if step is not None:
            record["step"] = int(step)
        if score is not None:
            record["score"] = float(score)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self.wandb_run is not None:
            artifact = _wandb.Artifact(
                f"model-{self.wandb_run.id}", type="model",
                metadata={"step": step, "score": score},
            )
            artifact.add_dir(str(path))
            self.wandb_run.log_artifact(artifact, aliases=[alias])

    def close(self):
        self._file.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


class MeanAccumulator:
    """Running means for epoch-level reduction of step metrics."""

    def __init__(self):
        self._sums = {}
        self._counts = {}

    def update(self, metrics, weight=1.0):
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v) * weight
            self._counts[k] = self._counts.get(k, 0.0) + weight

    def means(self):
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def reset(self):
        self._sums.clear()
        self._counts.clear()
