"""The port of the drift gate (color_transfer_tpu_torch/tools/deep_gate.py)
on the CPU at a tiny size (2 distortions of the grid, 64x96, a reduced
model), and the fused matcher route's knob through the command line:
``--model.matcher_fused_attention true`` must reach the model through
``predict`` and ``fit``, and an unknown key must still raise.
"""

import ast
import json
import math

import numpy as np
import pytest
from PIL import Image

from color_transfer_tpu_torch.models import gmflow
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.tools import deep_gate
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = {"dmsct": {"matcher_num_layers": 1, "matcher_num_reg_refine": 1},
        "dcmcs3di": {"extraction_layers": 1, "transfer_layers": 1, "channels": 8}}


def _gate(model, recipe):
    return deep_gate.run_gate(model, recipe, height=64, width=96, limit=2, device="cpu",
                              module_kwargs=TINY[model])


def _jax_summary_keys():
    """The keys of the summary dict examples/deep_gate.py prints."""
    tree = ast.parse(open("examples/deep_gate.py").read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["summary"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no summary dict in examples/deep_gate.py")


@pytest.mark.parametrize("model", ["dmsct", "dcmcs3di"])
def test_default_against_itself_has_no_drift(model):
    summary, rows = _gate(model, "")
    assert summary["pass"] and summary["n_distortions"] == len(rows) == 2
    assert summary["worst_max_abs"] == 0.0
    assert summary["worst_d_psnr_db"] == summary["worst_d_ssim"] == summary["worst_d_icid"] == 0


@pytest.mark.parametrize("model,recipe", [("dmsct", "fused"), ("dcmcs3di", "bf16")])
def test_recipes_report_the_jax_summary(model, recipe):
    summary, rows = _gate(model, recipe)
    assert list(summary) == _jax_summary_keys()
    assert summary["model"] == model and summary["recipe"] == recipe
    assert deep_gate.rows_finite(rows)
    assert summary["worst_max_abs"] > 0  # the recipe computes differently
    assert math.isfinite(summary["worst_pair_psnr_db"])


def test_occlusion_flips_report():
    """The gate row's trace: the fused matcher against f32 at one distortion.
    On the CPU the fused layers take their plain versions, which differ from
    the unfused layers only by rounding (the flows differ, by ~5e-5 here):
    no occlusion flag flips, so nothing is reported at flipped pixels. The
    card's run reports the real count."""
    report = deep_gate.occlusion_flips(28, height=64, width=96, device="cpu",
                                       module_kwargs=TINY["dmsct"])
    assert report["row"] == 28 and report["pixels"] == 64 * 96
    assert report["fwd_occ_flips"] == 0 and report["bwd_occ_flips"] == 0
    assert report["flow_max_d_at_flips"] == report["image_max_d_at_flips"] == 0.0
    assert report["image_sq_d_share_within_32px"] == 0.0
    assert 0.0 < report["flow_max_d_elsewhere"] < 1e-3  # the routes compute differently
    assert all(math.isfinite(report[k]) for k in ("pair_psnr", "image_max_d_elsewhere"))


@pytest.mark.parametrize("recipe", ["bf16", "bf16m", "bf16c", "bf16+fused", "bf16-nofuse",
                                    "bf16+refine32"])
def test_recipe_kwargs_are_the_jax_gates(recipe, monkeypatch):
    """Each DMSCT bf16 recipe's keywords are those examples/deep_gate.py::
    build_model passes the JAX model for the same name."""
    import examples.deep_gate as jgate
    from color_transfer_tpu.models import dmsct as jdmsct

    seen = {}

    class Capture:
        def __init__(self, **kwargs):
            seen.update(kwargs)

        def apply(self, *a, **k):
            raise AssertionError("not called")

    monkeypatch.setattr(jdmsct, "DMSCT", Capture)
    jgate.build_model("dmsct", recipe)
    assert deep_gate.recipe_kwargs("dmsct", recipe) == seen


def test_unknown_recipes_raise():
    with pytest.raises(ValueError, match="DMSCT matcher only"):
        deep_gate.recipe_kwargs("dcmcs3di", "fused")
    with pytest.raises(ValueError, match="unknown"):
        deep_gate.recipe_kwargs("dmsct", "fp8")


def test_command_line(capsys):
    rc = deep_gate.main(["--model", "dmsct", "--recipe", "fused", "--device", "cpu",
                         "--height", "64", "--width", "96", "--limit", "1",
                         "--model.matcher_num_layers", "1", "--model.matcher_num_reg_refine",
                         "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[gate] dmsct recipe=fused input 64x96"
    summary = json.loads(out[-1])
    assert rc == (0 if summary["pass"] else 1) and summary["n_distortions"] == 1


# -- the knob through predict and fit -------------------------------------------


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the matcher's calls of the fused sublayer op."""
    calls = []
    fused = gmflow.window_sublayer_fused

    def counted(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(gmflow, "window_sublayer_fused", counted)
    return calls


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for split, n in [("Train", 2), ("Validation", 1)]:
        (root / split).mkdir()
        for i in range(n):
            base = rng.integers(40, 215, (48, 64, 3), dtype=np.uint8)
            for view in ("L", "R"):
                Image.fromarray(base).save(root / split / f"{i:04d}_{view}.png")
    return root


def test_predict_takes_the_fused_route(data_root, tmp_path, fused_calls):
    pair = [str(data_root / "Validation" / f"0000_{v}.png") for v in ("L", "R")]
    args = ["predict", "--method", "dmsct", "--target", pair[0], "--reference", pair[1],
            "--output", str(tmp_path / "out.png"), "--device", "cpu",
            "--model.matcher_num_layers", "1", "--model.matcher_num_reg_refine", "1"]
    assert cli.main(args) == 0 and fused_calls == []
    assert cli.main(args + ["--model.matcher_fused_attention", "true"]) == 0
    assert len(fused_calls) == 4  # one block, self and cross, at both scales
    with pytest.raises(TypeError):
        cli.main(args + ["--model.matcher_fused_attentoin", "true"])


def test_fit_takes_the_fused_route(data_root, tmp_path, fused_calls):
    rc = cli.main(["fit", "--config", "configs/dmsct.yaml", "--data.data_dir",
                   str(data_root), "--log_dir", str(tmp_path), "--data.crop_size",
                   "[32, 48]", "--data.batch_size", "2", "--data.image_repeats", "1",
                   "--data.num_workers", "1", "--trainer.max_epochs", "1",
                   "--model.matcher_num_layers", "1", "--model.matcher_num_reg_refine", "1",
                   "--model.heavy_metrics", "false", "--model.matcher_fused_attention",
                   "true", "--device", "cpu"])
    assert rc == 0 and fused_calls
    meta = json.loads((tmp_path / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["hparams"]["matcher_fused_attention"] is True
