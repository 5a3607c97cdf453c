"""The torch port's training harness on the CPU: the datasets against the JAX
package's (the same crops and flips from the same seeds), config
overrides, and ``fit`` / ``validate`` / ``predict --ckpt_path`` through
color_transfer_tpu_torch.cli on a tiny PNG dataset (the layout
tests/test_harness.py builds), with a reduced matcher (1 layer, 1
refinement) and ``--device cpu``.

A restored checkpoint must reproduce ``eval_forward`` on its variables
exactly (the same float32 ops on the same weights).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from color_transfer_tpu.data import datasets as jdatasets
from color_transfer_tpu_torch.data import datasets
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.run.checkpoint import load_checkpoint, restore_eval_variables
from color_transfer_tpu_torch.run.config import load_config
from color_transfer_tpu_torch.run.modules import DMSCTModule
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = ["--data.crop_size", "[32, 48]", "--data.batch_size", "2",
        "--data.image_repeats", "1", "--data.num_workers", "2",
        "--trainer.log_every", "1", "--model.matcher_num_layers", "1",
        "--model.matcher_num_reg_refine", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for split, n in [("Train", 4), ("Validation", 2)]:
        d = root / split
        d.mkdir()
        for i in range(n):
            base = rng.integers(40, 215, (48, 64, 3), dtype=np.uint8)
            shift = rng.integers(-10, 10, (1, 1, 3))
            Image.fromarray(base).save(d / f"{i:04d}_L.png")
            Image.fromarray(np.clip(base.astype(int) + shift, 0, 255).astype(np.uint8)).save(
                d / f"{i:04d}_R.png")
    rw = root / "Real-World Test" / "scene0"
    rw.mkdir(parents=True)
    base = rng.integers(40, 215, (48, 64, 3), dtype=np.uint8)
    for suffix in ["L", "LD", "R"]:
        img = np.clip(base.astype(int) + rng.integers(-8, 8, (1, 1, 3)), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(rw / f"0000_{suffix}.png")
    return root


def _fit(data_root, log_dir, *extra):
    return cli.main(["fit", "--config", "configs/dmsct.yaml", "--data.data_dir",
                     str(data_root), "--log_dir", str(log_dir), *TINY, *extra])


def _records(log_dir):
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def run(data_root, tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("run")
    assert _fit(data_root, log_dir, "--trainer.max_epochs", "1") == 0
    return log_dir


def test_datasets_cut_the_jax_crops(data_root):
    for epoch in (0, 3):
        ours = datasets.ArtificialTrainValDataset(data_root / "Train", (20, 30), 2, seed=7)
        ref = jdatasets.ArtificialTrainValDataset(data_root / "Train", (20, 30), 2, seed=7)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref) == 8
        for i in range(len(ours)):
            a, b = ours[i], ref[i]
            np.testing.assert_array_equal(a["gt"], b["gt"])
            np.testing.assert_array_equal(a["reference"], b["reference"])
    rw, jrw = (m.RealWorldTestDataset(data_root / "Real-World Test")
               for m in (datasets, jdatasets))
    assert sorted(rw[0]) == sorted(jrw[0])
    np.testing.assert_array_equal(rw[0]["target"], jrw[0]["target"])


def test_loader_batches_and_epochs(data_root):
    ds = datasets.ArtificialTrainValDataset(data_root / "Train", (16, 16), 3, seed=1)
    loader = datasets.Loader(ds, batch_size=5, shuffle=True, num_threads=2, drop_last=True)
    assert len(loader) == 2
    first = [b["gt"] for b in loader]
    assert [b.shape for b in first] == [(5, 16, 16, 3)] * 2
    second = [b["gt"] for b in loader]
    assert not all(np.array_equal(a, b) for a, b in zip(first, second))
    loader.set_epoch(0)
    again = [b["gt"] for b in loader]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert loader.first_batch()["gt"].shape == (5, 16, 16, 3)


def test_config_overrides():
    cfg = load_config("configs/dmsct.yaml", {"data.data_dir": "D", "trainer.max_epochs": "2",
                                             "model.learning_rate": "1e-4",
                                             "data.crop_size": "[32, 48]"})
    assert cfg["data"]["init_args"]["data_dir"] == "D"
    assert cfg["data"]["init_args"]["crop_size"] == [32, 48]
    assert cfg["trainer"]["max_epochs"] == 2
    assert cfg["model"]["init_args"]["learning_rate"] == 1e-4
    assert cfg["model"]["init_args"]["decoder_channels"] == [256, 128, 64, 32]
    args, overrides = cli._parse(["fit", "--config", "c.yaml", "--trainer.max_epochs=3"])
    assert args.subcommand == "fit" and overrides == {"trainer.max_epochs": "3"}
    with pytest.raises(SystemExit):
        cli._parse(["fit", "--bogus", "1"])


def test_fit_writes_metrics_and_checkpoints(run):
    records = _records(run)
    keys = set().union(*records)
    for name in ("Training PSNR", "Training SSIM", "Training iCID", "Training FSIM",
                 "Training MSE Loss", "Training SSIM Loss", "Training Total Loss",
                 "Validation PSNR/dataloader_idx_0", "Validation PSNR/dataloader_idx_1",
                 "Validation MSE Loss/dataloader_idx_0", "epoch", "epoch_time"):
        assert name in keys, name
    assert [r["step"] for r in records if "Training Total Loss" in r] == [0, 1]
    assert all(np.isfinite(r["Training Total Loss"]) for r in records
               if "Training Total Loss" in r)
    for which in ("last", "best"):
        meta = json.loads((run / "checkpoints" / which / "meta.json").read_text())
        assert meta["step"] == 2 and meta["epoch"] == 0
        assert meta["hparams"]["encoder_name"] == "efficientnet-b2"
    payload, _ = load_checkpoint(run / "checkpoints" / "last")
    assert payload["step"] == 2 and len(payload["optimizer"]["state"]) > 100


def test_resume_continues_at_the_next_epoch(data_root, run, tmp_path):
    assert _fit(data_root, tmp_path, "--trainer.max_epochs", "2",
                "--ckpt_path", str(run / "checkpoints" / "last")) == 0
    records = _records(tmp_path)
    assert [r["epoch"] for r in records if "epoch" in r] == [1]
    assert [r["step"] for r in records if "Training Total Loss" in r] == [2, 3]
    meta = json.loads((tmp_path / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["step"] == 4 and meta["epoch"] == 1
    # The matcher stayed as initialised; the corrector moved.
    before, _ = load_checkpoint(run / "checkpoints" / "last")
    after, _ = load_checkpoint(tmp_path / "checkpoints" / "last")
    for name, value in before["variables"].items():
        same = torch.equal(value, after["variables"][name])
        if name.startswith("matcher."):
            assert same, name
    assert not torch.equal(before["variables"]["head.0.weight"],
                           after["variables"]["head.0.weight"])


def test_validate_prints_metrics(data_root, run, capsys):
    rc = cli.main(["validate", "--config", "configs/dmsct.yaml", "--data.data_dir",
                   str(data_root), "--log_dir", str(run / "validate"),
                   "--ckpt_path", str(run / "checkpoints" / "best"), *TINY])
    assert rc == 0
    results = json.loads(capsys.readouterr().out)
    assert "Validation PSNR/dataloader_idx_0" in results
    assert "Validation FSIM/dataloader_idx_1" in results
    # The restored best scores what fit's validation scored.
    logged = [r for r in _records(run) if "Validation PSNR/dataloader_idx_0" in r][-1]
    assert results["Validation PSNR/dataloader_idx_1"] == pytest.approx(
        logged["Validation PSNR/dataloader_idx_1"], rel=1e-6)


def test_predict_restores_the_checkpoint(data_root, run, tmp_path, capsys):
    scene = data_root / "Real-World Test" / "scene0"
    out = tmp_path / "corrected.png"
    best = run / "checkpoints" / "best"
    rc = cli.main(["predict", "--method", "dmsct", "--ckpt_path", str(best),
                   "--target", str(scene / "0000_LD.png"), "--reference",
                   str(scene / "0000_R.png"), "--output", str(out), "--device", "cpu",
                   "--model.matcher_num_layers", "1", "--model.matcher_num_reg_refine", "1"])
    assert rc == 0 and str(out) in capsys.readouterr().out
    module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1)
    variables = restore_eval_variables(module, best, device="cpu")

    def read(name):
        with Image.open(scene / name) as img:
            return torch.from_numpy(np.asarray(img.convert("RGB"), np.float32) / 255.0)[None]

    want = module.eval_forward(variables, {"target": read("0000_LD.png"),
                                           "reference": read("0000_R.png")})[0].numpy()
    want = np.clip(want * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with Image.open(out) as img:
        np.testing.assert_array_equal(np.asarray(img), want)
    # Another module shape does not fit the checkpoint.
    with pytest.raises(ValueError):
        restore_eval_variables(DMSCTModule(matcher_num_layers=2, matcher_num_reg_refine=1),
                               best, device="cpu")
