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
    return module.init_eval_variables(seed=0)


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


def test_unported_paths_raise(module, clip):
    t, r = clip
    with pytest.raises(NotImplementedError):
        color_transfer_between_videos(t, r, method="dmsct", module=module,
                                      ckpt_path="ckpt/best")
    with pytest.raises(NotImplementedError):
        DMSCTModule(encoder_weights="imagenet")


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
    assert "color_transfer_tpu_torch.run.cli" in modules


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
    variables = module.init_eval_variables(seed=0)
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
    a, b = module.init_eval_variables(seed=0), module.init_eval_variables(seed=0)
    c = module.init_eval_variables(seed=1)
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
