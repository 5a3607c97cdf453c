"""Checkpoints with best-metric gating — port of
color_transfer_tpu/run/checkpoint.py, with ``torch.save`` in place of orbax.

A checkpoint is a directory holding ``state.pt`` ({'variables': the model's
state_dict with its BatchNorm buffers, 'optimizer': the optimizer's
state_dict, 'step': updates applied}) and ``meta.json`` ({step, epoch,
hparams}). ``CheckpointManager`` keeps ``last`` and, gated on the monitored
metric, ``best`` (the reference's ModelCheckpoint on "Validation
PSNR/dataloader_idx_0", mode max). The JAX package's orbax directories
(``state/``) do not load here: their variables convert with
``tools/convert.py``.
"""

import json
import shutil
from pathlib import Path

import torch

from color_transfer_tpu_torch.methods.video import resolve_device


def train_state_payload(state):
    """What a checkpoint saves of a ``run.modules.TrainState``."""
    return {
        "variables": {k: v.detach() for k, v in state.variables.items()},
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
    }


def load_train_state(state, payload):
    """Restore a saved payload into ``state`` in place: the variables are
    copied into the tensors the optimizer holds."""
    with torch.no_grad():
        for k, v in payload["variables"].items():
            state.variables[k].copy_(v)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, ckpt_dir, monitor="Validation PSNR/dataloader_idx_0", mode="max"):
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self._best_path = self.ckpt_dir / "best_score.json"

    @property
    def best_score(self):
        if self._best_path.exists():
            return json.loads(self._best_path.read_text())["score"]
        return None

    def _improved(self, score):
        best = self.best_score
        if best is None:
            return True
        return score > best if self.mode == "max" else score < best

    def save_last(self, payload, hparams=None, step=None, epoch=None):
        self._save(self.ckpt_dir / "last", payload, hparams, step, epoch)

    def save_best(self, payload, metrics, hparams=None, step=None, epoch=None):
        """Save under 'best' iff the monitored metric improved. Returns True
        when saved."""
        score = float(metrics[self.monitor])
        if not self._improved(score):
            return False
        self._save(self.ckpt_dir / "best", payload, hparams, step, epoch)
        self._best_path.write_text(json.dumps({"score": score, "step": step}))
        return True

    def _save(self, path, payload, hparams, step, epoch):
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(payload, path / "state.pt")
        meta = {"step": step, "epoch": epoch, "hparams": hparams or {}}
        (path / "meta.json").write_text(json.dumps(meta))


def load_checkpoint(path, device="cpu"):
    """(payload, meta) of a checkpoint directory, tensors on ``device``."""
    path = Path(path).absolute()
    if not (path / "state.pt").exists():
        if (path / "state").is_dir():
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the port "
                "reads checkpoints written by its own trainer. Convert the "
                "JAX variables with color_transfer_tpu_torch/tools/convert.py "
                "(dmsct_state_dict_from_jax, dcmcs3di_state_dict_from_jax) "
                "and pass them as variables="
            )
        raise FileNotFoundError(f"no checkpoint (state.pt) in {path}")
    payload = torch.load(path / "state.pt", map_location=device)
    meta = json.loads((path / "meta.json").read_text())
    return payload, meta


def restore_eval_variables(module, ckpt_path, device=None):
    """A module's eval variables from a checkpoint directory on ``device``
    (None: the card; raises without one, pass "cpu" for the CPU), checked
    against the module's own state_dict keys and shapes; None for a
    parameterless module (the classical one)."""
    if getattr(module, "model", None) is None:
        return None
    payload, _ = load_checkpoint(ckpt_path, resolve_device(device))
    variables = payload["variables"]
    want = module.model.state_dict()
    if set(variables) != set(want):
        missing, extra = sorted(set(want) - set(variables)), sorted(set(variables) - set(want))
        raise ValueError(
            f"{ckpt_path} does not fit the module: missing {missing[:5]}, "
            f"unexpected {extra[:5]}"
        )
    for k, v in variables.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{ckpt_path}: {k} is {tuple(v.shape)}, the module "
                             f"has {tuple(want[k].shape)}")
    return variables
