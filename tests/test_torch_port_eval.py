"""Port parity: the paper's evaluation — ``ArtificialTestDataset``,
``DataModule.test_loaders``, ``ClassicalModule``, ``Trainer.test`` and the
``test`` subcommand (color_transfer_tpu_torch/data/datasets.py,
run/datamodule.py, run/modules.py, run/trainer.py, run/cli.py) — against
color_transfer_tpu on the JAX CLI test's fixture (tests/test_cli.py's
``_make_data``, 40 x 56 pairs, plus a ``Real-World Test/scene1`` of two
triplets), on the CPU.

Lines, each with its reason:
  * datasets and loaders: exact (the same PNG bytes);
  * ``Trainer.test`` for Reinhard, CCS and MK: PSNR within 1e-3 dB, SSIM,
    iCID and FSIM within 1e-4 (f32 on both sides, the methods' own lines
    are 1e-4 on the image);
  * IDT and grading, with JAX's rotations (its module's per-image keys)
    handed to the port: each image's mean |d| within test_torch_port_idt.py's
    mean line, 1e-4, and at most 1% of its pixels beyond that file's max
    line, one bin of the joint range (6.8e-3). The iteration is chaotic
    under rounding (that file says why), and where the reference's CDF is
    flat (empty bins: 2,240 samples over 255 bins here) the inverse CDF
    jumps, so one flipped sample can move a table entry by several bins:
    IDT's item 23 differs by 0.0216 at 0.09% of its pixels (grading stays
    within one bin);
  * DMSCT ``test`` on bridged weights (test_torch_port_dmsct.py's): each
    image within that file's end-to-end line, atol 1e-3; the metrics
    carried from it: PSNR within 20 log10(1 + d / rmse) of JAX's (d the
    images' largest difference, rmse JAX's error), SSIM, iCID and FSIM
    within 1e-3;
  * a batch of 2 against two batches of 1 with the same draws: exact for
    the rotation methods (image by image), 1e-6 for the batched ones.
"""

import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from color_transfer_tpu.data import datasets as jdatasets
from color_transfer_tpu.data import distortions as jdist
from color_transfer_tpu.methods import iterative as jit_
from color_transfer_tpu.run import datamodule as jdm
from color_transfer_tpu.run import modules as jmodules
from color_transfer_tpu.run.datamodule import to_float
from color_transfer_tpu.run.trainer import Trainer as JTrainer
from color_transfer_tpu_torch.data import datasets
from color_transfer_tpu_torch.data.distortions import setup_grid_distortions
from color_transfer_tpu_torch.methods.iterative import random_rotations
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.run.config import build_module
from color_transfer_tpu_torch.run.datamodule import DataModule
from color_transfer_tpu_torch.run.modules import ClassicalModule, DMSCTModule
from color_transfer_tpu_torch.run.trainer import Trainer, derive_seed
from color_transfer_tpu_torch.tools.convert import dmsct_state_dict_from_jax
from test_cli import _make_data
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dmsct import KW as DMSCT_KW
from test_torch_port_dmsct import jax_variables  # noqa: F401  (a fixture)

IDT_MAX, IDT_MEAN, IDT_BEYOND = 3**0.5 / 255, 1e-4, 0.01
LINEAR = ("reinhard", "correlated_color_space", "monge_kantorovitch")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = _make_data(tmp_path_factory.mktemp("eval"))
    rng = np.random.default_rng(1)
    scene = root / "Real-World Test" / "scene1"
    scene.mkdir(parents=True)
    for i in range(2):
        base = rng.integers(40, 215, (40, 56, 3))
        for suffix, cast in (("L", 0), ("LD", (-14, 6, 10)), ("R", 5)):
            img = np.clip(base + np.asarray(cast), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(scene / f"{i:04d}_{suffix}.png")
    return root


def _items(loader):
    return list(loader)


def test_artificial_test_dataset_matches_jax(data_root):
    ours = datasets.ArtificialTestDataset(data_root / "Test")
    ref = jdatasets.ArtificialTestDataset(data_root / "Test")
    assert len(ours) == len(ref) == 31
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a["distortion_idx"] == b["distortion_idx"] == i % 31
        for k in ("gt", "reference"):
            np.testing.assert_array_equal(a[k], b[k])


def test_test_loaders_match_jax(data_root):
    ours = DataModule(data_root, num_workers=2).test_loaders()
    ref = jdm.DataModule(data_root, num_workers=2).test_loaders()
    assert len(ours) == len(ref) == 2
    for a_loader, b_loader in zip(ours, ref):
        a_items, b_items = _items(a_loader), _items(b_loader)
        assert len(a_items) == len(b_items)
        for a, b in zip(a_items, b_items):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _jax_test(module, data_root, tmp_path, **kw):
    trainer = JTrainer(log_dir=tmp_path / "jax")
    return trainer.test(module, jdm.DataModule(data_root, num_workers=2), **kw)


def _port_test(module, data_root, tmp_path, **kw):
    trainer = Trainer(log_dir=tmp_path / "port", device="cpu")
    return trainer.test(module, DataModule(data_root, num_workers=2), **kw)


def _metric_lines(got, want, psnr=1e-3, other=1e-4):
    assert set(got) == set(want) and len(got) == 8
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= (psnr if k.startswith("Test PSNR") else other), (
            k, v, want[k])


@pytest.mark.parametrize("method", LINEAR)
def test_trainer_test_matches_jax(data_root, tmp_path, method):
    got = _port_test(ClassicalModule(method), data_root, tmp_path)
    want = _jax_test(jmodules.ClassicalModule(method), data_root, tmp_path)
    _metric_lines(got, want)


def _eval_batches(data_root):
    """Every test item as float batches, the artificial ones distorted by
    their grid index (JAX's grid: the item's target on both sides)."""
    grid = jdist.setup_grid_distortions()
    out = []
    for loader in jdm.DataModule(data_root, num_workers=2).test_loaders():
        for batch in loader:
            idx = batch.pop("distortion_idx", None)
            batch = to_float(batch)
            if "target" not in batch:
                batch["target"] = np.asarray(grid[int(idx[0])](jnp.asarray(batch["gt"][0])))[None]
            out.append(batch)
    return out


@pytest.mark.parametrize("method", ["idt", "automated_color_grading"])
def test_rotation_methods_match_jax_with_its_rotations(data_root, method):
    """Every test item through JAX's module (per-image keys from its seed
    and call count) and through the port's on the rotations those keys
    give."""
    jmod = jmodules.ClassicalModule(method, seed=42)
    port = ClassicalModule(method, seed=42)
    for call, batch in enumerate(_eval_batches(data_root)):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(42), call), 1)
        rotations = np.stack([np.asarray(jit_.random_rotations(k, 4)) for k in keys])
        want = np.asarray(jmod.eval_forward(None, {k: jnp.asarray(v) for k, v in batch.items()}))
        got = port.eval_forward(None, {k: torch.from_numpy(v) for k, v in batch.items()},
                                rotations=torch.from_numpy(rotations)).numpy()
        d = np.abs(got - want)
        beyond = float((d.max(axis=-1) > IDT_MAX).mean())
        assert d.mean() <= IDT_MEAN and beyond <= IDT_BEYOND, (call, d.mean(), beyond)


def test_rotation_draws():
    """The law of the draws: image j of call c from derive_seed(seed, c, j);
    the same seed and call count give the same rotations, the next call
    and another seed others."""
    a, b = ClassicalModule("idt", seed=7), ClassicalModule("idt", seed=7)
    first = a.draw_rotations(2)
    assert first.shape == (2, 4, 3, 3)
    torch.testing.assert_close(first, b.draw_rotations(2), atol=0, rtol=0)
    want = random_rotations(torch.Generator().manual_seed(derive_seed(7, 0, 1)), 4)
    torch.testing.assert_close(first[1], want, atol=0, rtol=0)
    second = a.draw_rotations(2)
    assert not torch.equal(first, second) and not torch.equal(first[0], first[1])
    assert not torch.equal(first, ClassicalModule("idt", seed=8).draw_rotations(2))
    eye = torch.eye(3).expand(2, 4, 3, 3)
    torch.testing.assert_close(first @ first.transpose(-1, -2), eye, atol=1e-6, rtol=0)
    assert ClassicalModule("reinhard").draw_rotations(2) is None


@pytest.mark.parametrize("method", ["idt", "automated_color_grading", "monge_kantorovitch"])
def test_batch_of_two_equals_two_batches_of_one(data_root, method):
    items = _eval_batches(data_root)[:2]
    batch = {k: torch.from_numpy(np.concatenate([b[k] for b in items])) for k in items[0]}
    module = ClassicalModule(method)
    rotations = module.draw_rotations(2)
    both = module.eval_forward(None, batch, rotations=rotations)
    exact = rotations is not None
    for j in range(2):
        one = module.eval_forward(None, {k: v[j : j + 1] for k, v in batch.items()},
                                  rotations=None if rotations is None else rotations[j : j + 1])
        torch.testing.assert_close(both[j : j + 1], one, atol=0 if exact else 1e-6, rtol=0)


def test_dmsct_test_matches_jax(data_root, tmp_path, jax_variables):
    """DMSCT ``test`` on bridged weights over four artificial items and the
    two real-world ones: the images on the end-to-end line, the metrics
    carried from it."""
    sd = dmsct_state_dict_from_jax(jax_variables["params"], jax_variables["batch_stats"])
    jmod = jmodules.DMSCTModule(**DMSCT_KW)
    port = DMSCTModule(**DMSCT_KW)
    d = 0.0
    rmse = np.inf
    for b_i, batch in enumerate(_eval_batches(data_root)):
        if 4 <= b_i < 31:
            continue
        want = np.asarray(jmod.eval_forward(jax_variables,
                                            {k: jnp.asarray(v) for k, v in batch.items()}))
        got = port.eval_forward(sd, {k: torch.from_numpy(v) for k, v in batch.items()})
        d = max(d, float(np.abs(got.numpy() - want).max()))
        rmse = min(rmse, float(np.sqrt(((want - batch["gt"]) ** 2).mean())))
    assert d <= 1e-3, d
    got = _port_test(port, data_root, tmp_path, variables=sd, max_batches=4)
    want = _jax_test(jmod, data_root, tmp_path, params=jax_variables, max_batches=4)
    _metric_lines(got, want, psnr=20 * np.log10(1 + d / rmse), other=1e-3)


def _run_cli(capsys, *argv):
    assert cli.main(list(argv)) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_cli_test_classical_dotted_func_spec(data_root, tmp_path, capsys):
    """configs/others.yaml with a reference dotted func_spec: the method it
    names, both loaders, the registry's class paths."""
    base = ["test", "--config", "configs/others.yaml", "--data.data_dir", str(data_root),
            "--data.num_workers", "2", "--log_dir", str(tmp_path), "--device", "cpu"]
    got = _run_cli(capsys, *base, "--model.func_spec",
                   "methods.linear.color_transfer_between_images")
    want = _port_test(ClassicalModule("reinhard"), data_root, tmp_path)
    assert got == pytest.approx(want, rel=1e-6)
    assert isinstance(build_module("methods.Runner", {"func_spec": "idt"}, seed=3),
                      ClassicalModule)
    assert build_module("classical", {"func_spec": "idt"}, seed=3).seed == 3


def _dcmcs3di_config(tmp_path, data_root, fused):
    cfg = {
        "seed_everything": 42,
        "model": {"class_path": "dcmcs3di", "init_args": {
            "extraction_layers": 1, "transfer_layers": 1, "channels": 8,
            "heavy_metrics": False, "fused_attention": fused}},
        "data": {"init_args": {"data_dir": str(data_root), "crop_size": [16, 24],
                               "image_repeats": 3, "batch_size": 8, "num_workers": 2}},
        "trainer": {"max_epochs": 1, "log_every": 1, "log_dir": str(tmp_path / "run")},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("fused", [True, False], ids=["chunked", "materialised"])
def test_cli_fit_test_predict_dcmcs3di(data_root, tmp_path, capsys, fused):
    """tests/test_cli.py's fit -> test --ckpt_path -> predict --ckpt_path on
    DCMCS3DI, with each training matcher; the test results equal the
    restored variables' own evaluation."""
    cfg = _dcmcs3di_config(tmp_path, data_root, fused)
    assert cli.main(["fit", "--config", cfg, "--device", "cpu"]) == 0
    ckpt = tmp_path / "run" / "checkpoints" / "best"
    assert ckpt.exists()
    capsys.readouterr()
    results = _run_cli(capsys, "test", "--config", cfg, "--ckpt_path", str(ckpt),
                       "--max_batches", "2", "--device", "cpu")
    assert "Test PSNR/dataloader_idx_0" in results and "Test PSNR/dataloader_idx_1" in results
    from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    module = DCMCS3DIModule(extraction_layers=1, transfer_layers=1, channels=8)
    variables = restore_eval_variables(module, ckpt, device="cpu")
    want = _port_test(module, data_root, tmp_path, variables=variables, max_batches=2)
    assert results == pytest.approx(want, rel=1e-6)
    events = [json.loads(line) for line in
              (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert {"best", "last"} <= {e.get("alias") for e in events if "checkpoint" in e}
    out_dir = tmp_path / "pred"
    assert cli.main(["predict", "--config", cfg, "--ckpt_path", str(ckpt), "--input_dir",
                     str(data_root / "Test"), "--output_dir", str(out_dir),
                     "--device", "cpu"]) == 0
    assert (out_dir / "0000_C.png").exists()


def test_cli_warnings_for_parameterless_modules(data_root, tmp_path, capsys):
    """A classical module ignores --ckpt_path (test and validate) and
    --eval_buckets, with JAX's warnings, and still evaluates."""
    base = ["--config", "configs/others.yaml", "--data.data_dir", str(data_root),
            "--data.num_workers", "2", "--log_dir", str(tmp_path), "--device", "cpu",
            "--max_batches", "1"]
    with pytest.warns(UserWarning, match="--ckpt_path ignored: module 'classical' is "
                                         "parameterless"):
        results = _run_cli(capsys, "test", *base, "--ckpt_path", str(tmp_path / "none"))
    assert np.isfinite(results["Test PSNR/dataloader_idx_1"])
    with pytest.warns(UserWarning, match="--eval_buckets ignored: module 'classical' "
                                         "cannot mask padded pixels"):
        bucketed = _run_cli(capsys, "test", *base, "--eval_buckets", "64")
    assert bucketed == results
    with pytest.warns(UserWarning, match="--ckpt_path ignored"):
        valid = _run_cli(capsys, "validate", *base, "--ckpt_path", str(tmp_path / "none"),
                         "--data.crop_size", "[16, 24]")
    assert any(k.startswith("Validation PSNR") for k in valid)


def test_grid_distortions_match_jax(data_root):
    """The 31 grid functions Trainer.test applies, on a fixture image."""
    gt = to_float(datasets.ArtificialTestDataset(data_root / "Test")[0])["gt"]
    for ours, ref in zip(setup_grid_distortions(), jdist.setup_grid_distortions()):
        np.testing.assert_allclose(ours(torch.from_numpy(gt)).numpy(),
                                   np.asarray(ref(jnp.asarray(gt))), atol=1e-5, rtol=0)
