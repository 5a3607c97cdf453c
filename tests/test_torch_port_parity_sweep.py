"""Port parity: the parity sweep (color_transfer_tpu_torch/tools/
parity_sweep.py) — the port's version of tests/test_parity_sweep.py, end
to end on fabricated reference-layout checkpoints and the synthetic mini
set (tests/test_cli.py's ``_make_data`` plus a ``Real-World Test`` scene),
on the CPU; and the classical rows against the JAX package's ``run_sweep``
on the same set. Lines:
  * the classical rows within 1e-4 relative of JAX's, metric by metric.
    Grading (the iterative MK) draws rotations; the port's module is handed
    JAX's draws (its per-image keys), as tests/test_torch_port_eval.py does;
  * the table's keys, shape and published column are JAX's.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from color_transfer_tpu.methods import iterative as jit_
from color_transfer_tpu.tools import parity_sweep as jsweep
from color_transfer_tpu_torch.run.modules import ClassicalModule
from color_transfer_tpu_torch.tools import parity_sweep
from test_cli import _make_data
from test_parity_sweep import _save_dcmcs3di_ckpt, _save_dmsct_ckpt
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

BATCHES = 3


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = _make_data(tmp_path_factory.mktemp("sweep"))
    rng = np.random.default_rng(2)
    scene = root / "Real-World Test" / "scene1"
    scene.mkdir(parents=True)
    for i in range(2):
        base = rng.integers(40, 215, (40, 56, 3))
        for suffix, cast in (("L", 0), ("LD", (-12, 5, 9)), ("R", 6)):
            Image.fromarray(np.clip(base + np.asarray(cast), 0, 255).astype(np.uint8)).save(
                scene / f"{i:04d}_{suffix}.png")
    return root


def _jax_rotations(self, batch_size):
    """JAX's ClassicalModule draws: split(fold_in(PRNGKey(seed), call), B)."""
    if self.n_iter is None:
        return None
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                               self._call_count), batch_size)
    self._call_count += 1
    return torch.from_numpy(np.stack([np.asarray(jit_.random_rotations(k, self.n_iter))
                                      for k in keys]))


def test_classical_rows_match_jax(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(ClassicalModule, "draw_rotations", _jax_rotations)
    got = parity_sweep.run_sweep(data_root, max_batches=BATCHES, num_workers=2,
                                 log_dir=tmp_path / "port", device="cpu")
    want = jsweep.run_sweep(data_root, max_batches=BATCHES, num_workers=2,
                            log_dir=str(tmp_path / "jax"))
    assert list(got) == list(want) == [label for label, _ in parity_sweep.CLASSICAL]
    assert parity_sweep.CLASSICAL == jsweep.CLASSICAL
    assert parity_sweep.PUBLISHED_ARTIFICIAL == jsweep.PUBLISHED_ARTIFICIAL
    for method, row in want.items():
        assert set(got[method]) == set(row) and len(row) == 8
        for k, v in row.items():
            assert abs(got[method][k] - v) <= 1e-4 * abs(v), (method, k, got[method][k], v)
    assert parity_sweep.format_table(got, parity_sweep.PUBLISHED_ARTIFICIAL).splitlines()[:2] \
        == jsweep.format_table(want, jsweep.PUBLISHED_ARTIFICIAL).splitlines()[:2]


def test_end_to_end_on_fabricated_assets(data_root, tmp_path, capsys):
    dc, dm = tmp_path / "dcmcs3di.ckpt", tmp_path / "dmsct.ckpt"
    _save_dcmcs3di_ckpt(dc)
    _save_dmsct_ckpt(dm)
    out = tmp_path / "table.md"
    rc = parity_sweep.main(["--data_dir", str(data_root), "--dcmcs3di_ckpt", str(dc),
                            "--dmsct_ckpt", str(dm), "--max_batches", "1",
                            "--num_workers", "1", "--eval_buckets", "32", "--device", "cpu",
                            "--out", str(out)])
    assert rc == 0
    table = out.read_text()
    for name in ["Reinhard", "Xiao", "linear MK", "iterative", "DCMCS3DI", "DMSCT"]:
        assert name in table, table
    assert "35.26" in table
    lines = table.splitlines()
    assert len(lines) == 2 + 6 * 2  # header, separator, each method on both sets
    assert all("nan" not in line for line in lines)
    assert "wrote" in capsys.readouterr().out


def test_format_table_shape():
    results = {"Reinhard et al.": {
        "Test PSNR/dataloader_idx_0": 34.0, "Test SSIM/dataloader_idx_0": 0.96,
        "Test FSIM/dataloader_idx_0": 0.98, "Test iCID/dataloader_idx_0": 0.12,
        "Test PSNR/dataloader_idx_1": 32.0, "Test SSIM/dataloader_idx_1": 0.93,
        "Test FSIM/dataloader_idx_1": 0.95, "Test iCID/dataloader_idx_1": 0.17}}
    table = parity_sweep.format_table(results, published=parity_sweep.PUBLISHED_ARTIFICIAL)
    assert table == jsweep.format_table(results, published=jsweep.PUBLISHED_ARTIFICIAL)
    lines = table.splitlines()
    assert lines[0].startswith("| Method | Dataset |") and len(lines) == 4
    assert "34.03" in table
    partial = {"Ours (DMSCT)": {"Test PSNR/dataloader_idx_0": 30.0}}
    assert parity_sweep.format_table(partial) == jsweep.format_table(partial)


def test_bf16_matcher_flag_is_refused(data_root):
    with pytest.raises(SystemExit):
        parity_sweep.main(["--data_dir", str(data_root), "--matcher_corr_dtype", "bfloat16"])
