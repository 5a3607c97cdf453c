"""Port parity: profiling (color_transfer_tpu_torch/utils/profiling.py) and
the Trainer's ``profile_dir`` / ``profile_steps`` and best-PSNR-gated image
panels (run/trainer.py) against color_transfer_tpu's Trainer, on the CPU.

A tiny DCMCS3DI (1 + 1 ResB blocks, 8 channels) fits tests/test_cli.py's
set for 3 epochs of 3 steps in both packages. The gate compares PSNRs that
random init and the two packages' random streams make differ, so both
sides' train steps and validations report one scripted PSNR an epoch;
the panels must then land at the same steps under the same names.
"""

import json

import pytest
import torch

from color_transfer_tpu.run import datamodule as jdm
from color_transfer_tpu.run import modules as jmodules
from color_transfer_tpu.run import trainer as jtrainer
from color_transfer_tpu_torch.run import modules, trainer
from color_transfer_tpu_torch.run.datamodule import DataModule
from color_transfer_tpu_torch.utils import profiling
from test_cli import _make_data
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

SMALL = dict(extraction_layers=1, transfer_layers=1, channels=8, heavy_metrics=False)
DATA = dict(crop_size=(16, 24), image_repeats=2, batch_size=2, num_workers=2)
STEPS, EPOCHS = 3, 3
TRAIN_PSNR, VAL_PSNR = (20.0, 19.0, 21.0), (10.0, 12.0, 11.0)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _make_data(tmp_path_factory.mktemp("prof"))


def test_trace_and_annotate(tmp_path):
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("span under test"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "span under test" in names and "aten::mm" in names


def _scripted(monkeypatch, train_cls, trainer_cls, port):
    """Train steps report TRAIN_PSNR[epoch]; validation VAL_PSNR[epoch]."""
    calls = {"steps": 0, "val": 0}
    orig = train_cls.train_step

    def train_step(self, *args, **kwargs):
        state, logs = orig(self, *args, **kwargs)
        epoch = calls["steps"] // STEPS
        calls["steps"] += 1
        if not port or "Training PSNR" in logs:
            logs = {**logs, "Training PSNR": TRAIN_PSNR[epoch]}
        return state, logs

    def validate(self, module, datamodule, state, step, max_batches=None):
        calls["val"] += 1
        return {"Validation PSNR/dataloader_idx_0": VAL_PSNR[calls["val"] - 1]}

    monkeypatch.setattr(train_cls, "train_step", train_step)
    monkeypatch.setattr(trainer_cls, "validate", validate)


def _images(log_dir):
    assert not (log_dir / "image_log_error.txt").exists()
    return sorted(p.name for p in (log_dir / "images").glob("*.png"))


def test_panels_land_where_jax_writes_them(data_root, tmp_path, monkeypatch):
    _scripted(monkeypatch, jmodules.DCMCS3DIModule, jtrainer.Trainer, port=False)
    _scripted(monkeypatch, modules.DCMCS3DIModule, trainer.Trainer, port=True)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jtrainer.Trainer(max_epochs=EPOCHS, log_dir=jax_dir, log_every=100).fit(
        jmodules.DCMCS3DIModule(**SMALL), jdm.DataModule(data_root, **DATA))
    trainer.Trainer(max_epochs=EPOCHS, log_dir=port_dir, log_every=100, device="cpu").fit(
        modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    want = _images(jax_dir)
    # Training panels after epochs 0 and 2 (steps 3, 9); validation after 0, 1.
    steps = sorted({int(n.rsplit("_", 2)[-2]) for n in want})
    assert steps == [3, 6, 9] and len(want) == 4 * 6
    assert _images(port_dir) == want


def test_panel_error_does_not_stop_the_run(data_root, tmp_path, monkeypatch):
    def broken(self, state, batch):
        raise RuntimeError("no panel")

    monkeypatch.setattr(modules.DCMCS3DIModule, "image_panels", broken)
    state = trainer.Trainer(max_epochs=1, log_dir=tmp_path, log_every=100, device="cpu").fit(
        modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    assert state.step == STEPS
    assert "no panel" in (tmp_path / "image_log_error.txt").read_text()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("image_log_error") == 1.0 for r in records)


@pytest.mark.parametrize("profile_steps,traced", [((1, 3), [1, 2, 3]), ((7, 20), [7, 8])])
def test_fit_profiles_its_steps(data_root, tmp_path, monkeypatch, profile_steps, traced):
    """``profile_dir``: steps profile_steps[0] to profile_steps[1] traced
    (a fit that ends first closes the trace at its end)."""
    seen = []
    orig = modules.DCMCS3DIModule.train_step

    def train_step(self, state, batch, seed, metrics=True):
        with profiling.annotate(f"step {state.step}"):
            seen.append(state.step)
            return orig(self, state, batch, seed, metrics)

    monkeypatch.setattr(modules.DCMCS3DIModule, "train_step", train_step)
    t = trainer.Trainer(max_epochs=EPOCHS, log_dir=tmp_path / "log", log_every=100,
                        device="cpu", profile_dir=tmp_path / "prof",
                        profile_steps=profile_steps)
    t.fit(modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    assert seen == list(range(STEPS * EPOCHS))
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert sorted(int(n.split()[1]) for n in names if n and n.startswith("step ")) == traced
    assert "aten::convolution" in names


def test_trainer_takes_jax_profile_defaults(tmp_path):
    t = trainer.Trainer(log_dir=tmp_path, device="cpu")
    j = jtrainer.Trainer.__init__.__defaults__
    assert t.profile_dir is None and t.profile_steps == (10, 15) == j[-1]
