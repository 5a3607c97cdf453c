"""The torch port's serving surface on the CPU: color_transfer_between_videos,
predict_pairs / collect_pairs, the CLI, and the rule that the port imports
nothing of JAX.

The port runs against itself here (its JAX parity is held by
test_torch_port_dmsct.py): a clip equals the per-frame forward to 1e-5
(the same float32 ops on the same frame; only batching may change the
order of sums).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule
from color_transfer_tpu_torch.run.predict import collect_pairs, predict_pairs
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

KW = dict(matcher_num_layers=1, matcher_num_reg_refine=1)
DC_KW = dict(extraction_layers=1, transfer_layers=1, channels=8)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def module():
    return DMSCTModule(**KW)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(3)
    t = rng.uniform(0, 1, (3, 32, 48, 3)).astype(np.float32)
    r = np.clip(t * 0.9 + 0.05, 0, 1).astype(np.float32)
    return t, r


@pytest.fixture(scope="module")
def variables(module):
    return module.init_eval_variables(seed=0, device="cpu")


@pytest.fixture(scope="module")
def per_frame(module, clip, variables):
    """The DMSCT forward of each frame on its own."""
    t, r = clip
    with torch.no_grad():
        return [
            torch.func.functional_call(
                module.model, variables,
                (torch.from_numpy(t[i : i + 1]), torch.from_numpy(r[i : i + 1])),
            )
            for i in range(len(t))
        ]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_video_matches_per_frame_forward(module, clip, variables, per_frame,
                                         batch_size):
    t, r = clip
    out = color_transfer_between_videos(t, r, method="dmsct", batch_size=batch_size,
                                        module=module, variables=variables)
    assert out.shape == (3, 32, 48, 3) and out.dtype == torch.float32
    for i, frame in enumerate(per_frame):
        torch.testing.assert_close(out[i : i + 1], frame, atol=1e-5, rtol=0)


def test_eval_forward_turns_tf32_off(module, clip, variables):
    """cuDNN's TF32 convolutions are off inside eval_forward and the caller's
    setting is back after it."""
    t, r = clip
    seen = []
    handle = module.model.head.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32)
    )
    before = torch.backends.cudnn.allow_tf32
    try:
        module.eval_forward(variables,
                            {"target": torch.from_numpy(t[:1]),
                             "reference": torch.from_numpy(r[:1])})
    finally:
        handle.remove()
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 == before


def test_video_default_variables_are_seeded(module, clip, per_frame):
    """Without variables the clip runs on the seed-0 random init."""
    t, r = clip
    out = color_transfer_between_videos(t[:1], r[:1], method="dmsct", module=module,
                                        device="cpu")
    torch.testing.assert_close(out, per_frame[0], atol=0, rtol=0)


def test_unported_paths_raise(module, clip, tmp_path):
    """Pretrained encoder weights raise; so does a JAX orbax checkpoint
    directory (its variables convert with tools/convert.py)."""
    t, r = clip
    (tmp_path / "best" / "state").mkdir(parents=True)
    (tmp_path / "best" / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="orbax.*tools/convert.py"):
        color_transfer_between_videos(t, r, method="dmsct", module=module, device="cpu",
                                      ckpt_path=tmp_path / "best")
    with pytest.raises(NotImplementedError):
        DMSCTModule(encoder_weights="imagenet")


def test_default_device_is_the_card():
    from color_transfer_tpu_torch.methods.video import default_device

    assert default_device() == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch, clip, tmp_path):
    """No card and no device="cpu": the entry points raise and name the
    CPU option; they do not run on the CPU."""
    from color_transfer_tpu_torch.run.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, r = clip
    with pytest.raises(RuntimeError, match="device='cpu'"):
        color_transfer_between_videos(t, r, method="reinhard")
    with pytest.raises(RuntimeError, match="--device cpu"):
        color_transfer_between_videos(t, r, method="dmsct", module_kwargs=KW)
    _write_pair(tmp_path, "0000", t[0], r[0])
    pairs = collect_pairs(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_pairs(pairs, tmp_path / "out", method="reinhard")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["predict", "--method", "reinhard", "--target",
                  str(tmp_path / "0000_LD.png"), "--reference", str(tmp_path / "0000_R.png"),
                  "--output", str(tmp_path / "o.png")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(log_dir=tmp_path / "run")
    assert not (tmp_path / "out").exists() and not (tmp_path / "o.png").exists()


def test_initialisers_default_to_the_card(monkeypatch, tmp_path):
    """The weight initialisers resolve a missing device to the card as every
    other entry point does (JAX's init_eval_variables puts the variables on
    the default accelerator): without a card and without device they raise
    the resolve_device error; with device="cpu" they return CPU tensors."""
    from color_transfer_tpu_torch.methods.video import build_deep
    from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables

    module, dc = DMSCTModule(**KW), DCMCS3DIModule(**DC_KW)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"variables": module.init_eval_variables(device="cpu")}, ckpt / "state.pt")
    (ckpt / "meta.json").write_text("{}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "DMSCTModule.init_eval_variables": lambda **d: module.init_eval_variables(**d),
        "DCMCS3DIModule.init_eval_variables": lambda **d: dc.init_eval_variables(**d),
        "restore_eval_variables": lambda **d: restore_eval_variables(module, ckpt, **d),
        "build_deep": lambda **d: build_deep("dmsct", module_kwargs=KW, **d)[1],
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device: pass device='cpu'"):
            call()
        variables = call(device="cpu")
        assert variables and all(v.device.type == "cpu" for v in variables.values()), name


def _write_pair(directory, stem, t, r, distorted=True):
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    Image.fromarray((t * 255).astype(np.uint8)).save(
        directory / f"{stem}_{'LD' if distorted else 'L'}.png")
    Image.fromarray((r * 255).astype(np.uint8)).save(directory / f"{stem}_R.png")


def test_predict_pairs_writes_pngs(tmp_path, clip):
    from PIL import Image

    t, r = clip
    data = tmp_path / "data"
    _write_pair(data / "scene1", "0000", t[0], r[0])
    _write_pair(data / "scene1", "0001", t[1], r[1], distorted=False)
    _write_pair(data / "scene2", "0000", t[2][:16], r[2][:16])  # another shape
    (data / "scene2" / "0009_R.png").write_bytes(b"")  # no target: skipped
    pairs = collect_pairs(data)
    assert [str(rel) for _, _, rel in pairs] == [
        "scene1/0000_C.png", "scene1/0001_C.png", "scene2/0000_C.png"
    ]
    assert pairs[0][0].name == "0000_LD.png" and pairs[1][0].name == "0001_L.png"
    written = predict_pairs(pairs, tmp_path / "out", method="dmsct", module_kwargs=KW,
                            device="cpu")
    assert sorted(p.relative_to(tmp_path / "out").as_posix() for p in written) == [
        "scene1/0000_C.png", "scene1/0001_C.png", "scene2/0000_C.png"
    ]
    with Image.open(tmp_path / "out" / "scene2" / "0000_C.png") as img:
        assert img.size == (48, 16) and img.mode == "RGB"


def test_cli_single_pair(tmp_path, clip, capsys):
    t, r = clip
    _write_pair(tmp_path, "0000", t[0], r[0])
    out = tmp_path / "corrected.png"
    rc = cli.main([
        "predict", "--method", "dmsct", "--target", str(tmp_path / "0000_LD.png"),
        "--reference", str(tmp_path / "0000_R.png"), "--output", str(out),
        "--device", "cpu", "--model.matcher_num_layers", "1",
        "--model.matcher_num_reg_refine=1",
    ])
    assert rc == 0 and out.exists()
    assert str(out) in capsys.readouterr().out


def test_cli_model_args():
    args, model_args = cli._parse([
        "predict", "--model.matcher_num_layers", "2",
        "--model.decoder_channels=[64, 32]", "--model.encoder_weights", "null",
        "--model.encoder_name", "efficientnet-b0",
    ])
    assert args.method == "monge_kantorovitch"  # the JAX package's default
    assert model_args == {"matcher_num_layers": 2, "decoder_channels": [64, 32],
                          "encoder_weights": None, "encoder_name": "efficientnet-b0"}
    with pytest.raises(SystemExit):
        cli._parse(["predict", "--bogus", "1"])


def test_port_imports_no_jax():
    """Every module of the port imports without jax, jaxlib, flax or the JAX
    package being loaded."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "color_transfer_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'color_transfer_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("run.cli", "run.trainer", "run.checkpoint", "run.config",
                 "run.datamodule", "run.logging", "ops.warp_adjoint", "metrics.fsim",
                 "metrics.icid", "data.datasets", "data.distortions", "run.bucketing",
                 "run.modules", "ops.parallax_train", "models.pasm", "models.dcmcs3di",
                 "parallel", "parallel.mesh", "parallel.multihost", "parallel.data_parallel",
                 "tools.postprocess"):
        assert f"color_transfer_tpu_torch.{name}" in modules, name


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dcmcs3di_video_matches_model_call(clip, compute_dtype):
    """color_transfer_between_videos(method="dcmcs3di") runs the JAX
    module's call, the materialised matcher at inference, frame by frame,
    on the seed-0 weights: equal to the model called on each frame."""
    t, r = clip
    module = DCMCS3DIModule(**DC_KW, compute_dtype=compute_dtype)
    out = color_transfer_between_videos(t, r, method="dcmcs3di", device="cpu",
                                        module_kwargs=dict(DC_KW, compute_dtype=compute_dtype))
    assert out.shape == (3, 32, 48, 3) and out.dtype == torch.float32
    variables = module.init_eval_variables(seed=0, device="cpu")
    with torch.no_grad():
        for i in range(len(t)):
            want, _ = torch.func.functional_call(
                module.model, variables,
                (torch.from_numpy(t[i : i + 1]), torch.from_numpy(r[i : i + 1])),
                {"inference": True},
            )
            torch.testing.assert_close(out[i : i + 1], want, atol=0, rtol=0)


def test_dcmcs3di_init_is_uniform_and_seeded():
    """init_eval_variables: U(+-1/sqrt(fan_in)) for kernels and biases,
    the same for one seed, another for another seed."""
    module = DCMCS3DIModule(**DC_KW)
    a, b = (module.init_eval_variables(seed=0, device="cpu") for _ in range(2))
    c = module.init_eval_variables(seed=1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["extraction.0.weight"], c["extraction.0.weight"])
    for name in ("extraction.0", "transfer.0", "matcher.query", "transfer.3"):
        w, bias = a[f"{name}.weight"], a[f"{name}.bias"]
        bound = w[0].numel() ** -0.5
        assert float(w.abs().max()) <= bound and float(bias.abs().max()) <= bound
        assert float(w.abs().max()) > 0.5 * bound and float(bias.abs().max()) > 0


def test_dcmcs3di_module_kwargs():
    assert DCMCS3DIModule(**DC_KW, compute_dtype="bfloat16").model.compute_dtype \
        == torch.bfloat16
    assert DCMCS3DIModule(**DC_KW).model.compute_dtype is None
    with pytest.raises(ValueError):
        DCMCS3DIModule(**DC_KW, compute_dtype="bogus")
    with pytest.raises(TypeError):
        DCMCS3DIModule(**DC_KW, matcher_num_layers=1)


def test_cli_predict_dcmcs3di(tmp_path, clip, capsys):
    t, r = clip
    _write_pair(tmp_path, "0000", t[0], r[0])
    out = tmp_path / "corrected.png"
    args = [
        "predict", "--method", "dcmcs3di", "--target", str(tmp_path / "0000_LD.png"),
        "--reference", str(tmp_path / "0000_R.png"), "--output", str(out),
        "--device", "cpu", "--model.extraction_layers", "1",
        "--model.transfer_layers=1", "--model.channels", "8",
        "--model.compute_dtype", "bfloat16",
    ]
    assert cli.main(args) == 0 and out.exists()
    assert str(out) in capsys.readouterr().out
    with pytest.raises(TypeError):  # an unknown --model.X keeps raising
        cli.main(args + ["--model.bogus", "1"])


# -- predict's method resolution (the JAX package's run/cli.py) -----------------


@pytest.fixture
def one_pair(tmp_path, clip):
    t, r = clip
    _write_pair(tmp_path, "0000", t[0], r[0])
    return ["predict", "--target", str(tmp_path / "0000_LD.png"), "--reference",
            str(tmp_path / "0000_R.png"), "--device", "cpu"]


def _predict_bytes(one_pair, tmp_path, name, *extra):
    out = tmp_path / f"{name}.png"
    assert cli.main([*one_pair, "--output", str(out), *extra]) == 0
    return out.read_bytes()


def test_predict_config_builds_the_configs_module(one_pair, tmp_path, monkeypatch):
    """``--config configs/dmsct.yaml`` serves DMSCT built with the config's
    init_args, command-line keywords folded in."""
    from color_transfer_tpu_torch.methods import video

    built = []
    real = video.build_deep

    def spy(*args, **kwargs):
        module, variables = real(*args, **kwargs)
        built.append(module)
        return module, variables

    monkeypatch.setattr(video, "build_deep", spy)
    _predict_bytes(one_pair, tmp_path, "cfg", "--config", "configs/dmsct.yaml",
                   "--model.matcher_num_layers", "1", "--model.matcher_num_reg_refine", "1")
    module = built[0]
    assert isinstance(module, DMSCTModule)
    assert module.hparams["decoder_channels"] == [256, 128, 64, 32]  # the config's
    assert module.hparams["encoder_name"] == "efficientnet-b2"
    assert module.hparams["matcher_num_layers"] == 1  # the command line's
    assert len(module.model.matcher.transformer.layers) == 1


def test_predict_func_spec_selects_the_classical_method(one_pair, tmp_path):
    """``--model.func_spec idt`` is ``--method idt``; no option at all is
    monge_kantorovitch; the two differ."""
    torch.manual_seed(0)
    by_spec = _predict_bytes(one_pair, tmp_path, "spec", "--model.func_spec", "idt")
    torch.manual_seed(0)
    by_method = _predict_bytes(one_pair, tmp_path, "method", "--method", "idt")
    default = _predict_bytes(one_pair, tmp_path, "default")
    mk = _predict_bytes(one_pair, tmp_path, "mk", "--method", "monge_kantorovitch")
    assert by_spec == by_method
    assert default == mk
    assert default != by_method


def test_predict_method_overrides_the_config(one_pair, tmp_path):
    """``--method reinhard --config configs/dmsct.yaml``: none of the
    config's DMSCT keywords reach the classical method."""
    args, kwargs = cli._parse([*one_pair, "--method", "reinhard", "--config",
                               "configs/dmsct.yaml"])
    assert args.method == "reinhard" and kwargs == {}
    with_cfg = _predict_bytes(one_pair, tmp_path, "a", "--method", "reinhard",
                              "--config", "configs/dmsct.yaml")
    assert with_cfg == _predict_bytes(one_pair, tmp_path, "b", "--method", "reinhard")
    # a deep --method other than the config's class keeps only the flat keywords
    args, kwargs = cli._parse(["predict", "--method", "dcmcs3di", "--config",
                               "configs/dmsct.yaml"])
    assert args.method == "dcmcs3di" and kwargs == {}
    # ... and the config's own class named explicitly keeps its init_args
    args, kwargs = cli._parse(["predict", "--method", "dmsct", "--config",
                               "configs/dmsct.yaml", "--model.matcher_num_layers", "2"])
    assert kwargs["encoder_depth"] == 4 and kwargs["matcher_num_layers"] == 2


@pytest.mark.parametrize("argv,method", [
    ([], "monge_kantorovitch"),
    (["--model.func_spec", "idt"], "idt"),
    (["--config", "configs/dmsct.yaml"], "dmsct"),
    (["--config", "configs/others.yaml"], None),  # the classical config's func_spec
    (["--method", "reinhard", "--model.func_spec", "idt"], "reinhard"),
])
def test_predict_method_resolution(argv, method):
    args, _ = cli._parse(["predict", *argv])
    if method is None:
        import yaml

        spec = yaml.safe_load(open("configs/others.yaml"))["model"]["init_args"]
        method = spec.get("func_spec") or "monge_kantorovitch"
    assert args.method == method


# -- the gate records at the serving surfaces (methods/gates.py) -----------------


@pytest.fixture
def stub_deep(monkeypatch):
    """A deep build that costs nothing: the surfaces must consult the gate
    records before they build."""
    from color_transfer_tpu_torch.methods import video

    class Stub:
        def eval_forward(self, variables, batch):
            return batch["target"]

    monkeypatch.setattr(video, "build_deep",
                        lambda *a, **k: (Stub(), {"w": torch.zeros(1)}))


@pytest.fixture
def failing_bf16(monkeypatch):
    from color_transfer_tpu_torch.methods import gates

    monkeypatch.setitem(gates.RECORDS, ("dcmcs3di", "bf16"),
                        ("fail", "worst dSSIM -7.38e-4"))


def test_gate_records_are_the_ports():
    from color_transfer_tpu_torch.methods import gates

    assert gates.recipe_verdict("dmsct", None)[0] == "pass"
    verdict, detail = gates.recipe_verdict("dmsct", {"matcher_fused_attention": True})
    assert verdict == "pass" and "99.94" in detail
    assert gates.recipe_verdict("dcmcs3di", {})[0] == "pass"
    for dtype in ("bfloat16", torch.bfloat16):
        verdict, detail = gates.recipe_verdict("dcmcs3di", {"compute_dtype": dtype})
        assert verdict == "pass" and "1 of 3" in detail and "-7.38e-4" in detail
    assert gates.recipe_verdict("reinhard", {})[0] == "unrecorded"
    assert "TPU" not in "".join(d for _, d in gates.RECORDS.values())


def test_video_takes_allow_ungated(stub_deep, clip):
    import warnings

    t, r = clip
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = color_transfer_between_videos(
            t, r, method="dmsct", device="cpu", allow_ungated=True,
            module_kwargs={"matcher_fused_attention": True})
        color_transfer_between_videos(t, r, method="dcmcs3di", device="cpu",
                                      module_kwargs={"compute_dtype": "bfloat16"})
    assert out.shape == (3, 32, 48, 3)


def test_failing_record_warns_unless_acknowledged(stub_deep, failing_bf16, clip, tmp_path):
    import warnings

    t, r = clip
    kw = {"compute_dtype": "bfloat16"}
    with pytest.warns(UserWarning, match="FAILED its quality gate.*-7.38e-4"):
        color_transfer_between_videos(t, r, method="dcmcs3di", device="cpu",
                                      module_kwargs=kw)
    _write_pair(tmp_path, "0000", t[0], r[0])
    pairs = collect_pairs(tmp_path)
    with pytest.warns(UserWarning, match="FAILED its quality gate"):
        predict_pairs(pairs, tmp_path / "out", method="dcmcs3di", module_kwargs=kw,
                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        color_transfer_between_videos(t, r, method="dcmcs3di", device="cpu",
                                      module_kwargs=kw, allow_ungated=True)
        predict_pairs(pairs, tmp_path / "out", method="dcmcs3di", module_kwargs=kw,
                      device="cpu", allow_ungated=True)
        color_transfer_between_videos(t, r, method="dcmcs3di", device="cpu")  # f32


def test_cli_allow_ungated(stub_deep, failing_bf16, one_pair, tmp_path):
    import warnings

    args, _ = cli._parse(["predict", "--allow_ungated"])
    assert args.allow_ungated is True
    assert cli._parse(["predict"])[0].allow_ungated is False
    argv = [*one_pair, "--method", "dcmcs3di", "--model.compute_dtype", "bfloat16",
            "--output", str(tmp_path / "o.png")]
    with pytest.warns(UserWarning, match="FAILED its quality gate"):
        assert cli.main(argv) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli.main(argv + ["--allow_ungated"]) == 0


def test_kernel_ab_times_two_copies_side_by_side(tmp_path):
    """tools/kernel_ab.py: the package copied under another name imports
    beside the tree's (its own modules, its own launch counts), and each
    case is timed in the order other, tree, tree, other."""
    import importlib

    from color_transfer_tpu_torch.tools import kernel_ab

    other = kernel_ab.rename_package(REPO / "color_transfer_tpu_torch", tmp_path / "ctt_other")
    assert not (other / "_build").exists()
    assert "color_transfer_tpu_torch" not in (other / "ops" / "row_attention.py").read_text()
    rows = kernel_ab.run(other, torch.device("cpu"), small=True, iters=1)
    # B5: 2 modes x 2 dtypes; B6: 3 chains x 2 batches; B7: 4 levels x 2
    # flows; B2a, B2b (cross; self with the shift and the residual) and B2c;
    # B2a, B2b and B2c in bf16 (one shape; three at full size); B1: 2 shapes
    # x 2 flows in f32 and bf16; B4: 3 levels (six at full size).
    assert len(rows) == 4 + 6 + 8 + 4 + 4 + 8 + 3
    assert [r["case"] for r in kernel_ab.run(other, torch.device("cpu"), small=True, iters=1,
                                             only="^window")] == [
        r["case"] for r in rows[18:21] + rows[22:25]]
    assert rows[21]["case"].startswith("ffn ")
    assert all(" bf16 " in r["case"] for r in rows[22:26])
    assert rows[25]["case"].startswith("ffn bf16 ")
    assert [r["case"].split()[0] for r in rows[26:]] == ["local_corr"] * 8 + ["regrain_sweeps"] * 3
    assert [" bf16 " in r["case"] for r in rows[26:34]] == [False, True] * 4
    assert [r["case"] for r in kernel_ab.run(other, torch.device("cpu"), small=True, iters=1,
                                             only="ffn bf16|local_corr bf16")] == [
        r["case"] for r in rows[25:34] if " bf16 " in r["case"]]
    for row in rows:
        assert row["order"] == ["other", "tree", "tree", "other"]
        assert len(row["ms"]) == 4 and all(t > 0 for t in row["ms"])
    theirs = importlib.import_module("ctt_other.ops.conv_chain")
    from color_transfer_tpu_torch.ops import conv_chain as ours

    assert theirs is not ours and theirs.resb_chain is not ours.resb_chain
