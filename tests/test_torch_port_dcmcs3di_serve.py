"""DCMCS3DI served through the port's video entry, on the CPU where B5 takes
its plain version, against the benchmark's banded plain reference
(``benchmark/reference/dcmcs3di_serve.py``) on seeded random weights at
2 + 1 residual blocks of 64 channels and 48x96 frames: the materialised
matcher, which a batch takes where its volumes fit on the card, and the
row-attention route, which it takes where they do not
(``run/modules.py::materialised_matcher_fits``, made to answer no here);
the banded reference against the whole-volume reference forward; the
memory rule, and which operand precision the row-attention route takes;
the spans of both routes.

Tolerances: the port and the reference run the same float32 operations on
the same weights and frames; the row-attention route's softmax multiplies
by 1/C where the reference divides by C (exact at C = 64, a power of two),
and the two batch their attention products over other sets of rows, which
may change the order of sums: 1e-6 on outputs of scale 1 (float32's
rounding ~6e-8, a few roundings through the transfer net). B5 on bf16
operands departs by more than 10x that line (its operands carry 2^-9 of
relative rounding)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import dcmcs3di as ref_dc
from benchmark.reference import dcmcs3di_serve as ref_serve
from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
from color_transfer_tpu_torch.models import dcmcs3di as dcm
from color_transfer_tpu_torch.run import modules
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule
from color_transfer_tpu_torch.utils import profiling
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

SIZES = dict(extraction_layers=2, transfer_layers=1, channels=64)
LINE = 1e-6  # float32 on both sides, sums in another order (module docstring)
GIB = 2**30


@pytest.fixture(scope="module")
def clip():
    """Two 48x96 stereo pairs: smooth scenes, the reference shifted by 5 px
    and colour-shifted."""
    rng = np.random.default_rng(23)
    base = rng.uniform(0, 1, (2, 12, 26, 3))
    scene = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :48, :101]
    t = scene[:, :, 5:].astype(np.float32)
    r = np.clip(scene[:, :, :96] * 0.9 + 0.04, 0, 1).astype(np.float32)
    return np.ascontiguousarray(t), np.ascontiguousarray(r)


@pytest.fixture(scope="module")
def variables():
    return DCMCS3DIModule(**SIZES).init_eval_variables(seed=5, device="cpu")


@pytest.fixture(scope="module")
def reference(variables):
    model = ref_dc.build({"sizes": SIZES})
    model.load_state_dict(variables)
    return model.eval()


@pytest.fixture
def no_room(monkeypatch):
    """Every batch's materialised volumes too large for its card: the
    row-attention route."""
    monkeypatch.setattr(modules, "materialised_matcher_fits", lambda target: False)


def _serve(clip, variables, **kwargs):
    t, r = clip
    return color_transfer_between_videos(
        t, r, method="dcmcs3di", device="cpu", variables=variables,
        module_kwargs=dict(SIZES, **kwargs))


def _reference(reference, clip, **kwargs):
    t, r = (torch.from_numpy(x) for x in clip)
    with torch.no_grad():
        return torch.cat([ref_serve.serve(reference, t[i:i + 1], r[i:i + 1], **kwargs)[0]
                          for i in range(len(t))])


def test_video_entry_kernel_route_matches_the_reference(clip, variables, reference, no_room):
    out = _serve(clip, variables)
    assert out.shape == (2, 48, 96, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, _reference(reference, clip), atol=LINE, rtol=0)


def test_video_entry_materialised_route_matches_the_reference(clip, variables, reference):
    out = _serve(clip, variables)
    assert out.shape == (2, 48, 96, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, _reference(reference, clip), atol=LINE, rtol=0)


def test_bf16_operands_depart_from_the_reference(clip, variables, reference, monkeypatch,
                                                 no_room):
    """B5 on bf16 operands inside the f32 recipe is a lower precision than
    the configuration states: its output leaves the line."""
    inner = dcm.fused_parallax_inference
    monkeypatch.setattr(dcm, "fused_parallax_inference",
                        lambda *a, precise, **k: inner(*a, precise=False, **k))
    out = _serve(clip, variables)
    assert float((out - _reference(reference, clip)).abs().max()) > 10 * LINE


@pytest.mark.parametrize("band", [1, 5, 7, 48, None])
def test_banded_reference_is_the_whole_volume_forward(clip, reference, band):
    """Rows are independent, so bands of any size (7 does not divide 48)
    give the whole-volume forward of ``reference/dcmcs3di.py``."""
    t, r = (torch.from_numpy(x[:1]) for x in clip)
    with torch.no_grad():
        got, outputs = ref_serve.serve(reference, t, r, band=band)
        want = reference(t, r)[0]
    assert outputs == {}
    torch.testing.assert_close(got, want, atol=LINE, rtol=0)


def test_band_rows_bound_the_volume():
    assert ref_serve.band_rows(1, 1920) == 72  # 72 x 1920^2 x 4 bytes <= 1 GiB
    assert 4 * 72 * 1920 * 1920 <= ref_serve.BAND_BYTES < 4 * 73 * 1920 * 1920
    assert ref_serve.band_rows(1, 10**6) == 1


def _routes(monkeypatch):
    """The ``precise`` of every B5 call the model makes."""
    calls, inner = [], dcm.fused_parallax_inference

    def spy(*args, precise, **kwargs):
        calls.append(precise)
        return inner(*args, precise=precise, **kwargs)

    monkeypatch.setattr(dcm, "fused_parallax_inference", spy)
    return calls


@pytest.mark.parametrize("compute_dtype,precise", [(None, True), ("bfloat16", False)])
def test_precise_follows_the_recipe(clip, variables, monkeypatch, no_room, compute_dtype,
                                    precise):
    calls = _routes(monkeypatch)
    _serve(clip, variables, compute_dtype=compute_dtype)
    assert calls == [precise, precise]  # one call a frame


@pytest.mark.parametrize("batch,free,idle,fits", [
    (1, 78 * GIB, 0, True),  # 59.3 GiB of volumes at 1080x1920, 66.7 with headroom
    (1, 60 * GIB, 10 * GIB, True),  # the allocator's idle blocks count as free
    (1, 60 * GIB, 0, False),
    (2, 78 * GIB, 0, False),  # two frames' volumes: 118.7 GiB
])
def test_the_route_follows_the_card_memory(monkeypatch, batch, free, idle, fits):
    """The materialised matcher where its four float32 (B, H, W, W) volumes
    and an eighth more fit in the card's free memory."""
    target = SimpleNamespace(device=torch.device("cuda", 0), shape=(batch, 1080, 1920, 3))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (free, 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 20 * GIB + idle)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 20 * GIB)
    assert modules.materialised_matcher_fits(target) is fits


def test_the_route_is_decided_once_a_shape(clip, variables, monkeypatch):
    """The free-memory query waits on the card, so a module asks it on the
    first batch of each shape and keeps the answer."""
    asked, calls = [], _routes(monkeypatch)
    monkeypatch.setattr(modules, "materialised_matcher_fits",
                        lambda target: asked.append(tuple(target.shape)) and False)
    module = DCMCS3DIModule(**SIZES)
    t, r = (torch.from_numpy(x) for x in clip)
    for rows in (48, 48, 32, 48):
        module.eval_forward(variables, {"target": t[:1, :rows], "reference": r[:1, :rows]})
    assert asked == [(1, 48, 96, 3), (1, 32, 96, 3)] and calls == [True] * 4


def test_cpu_keeps_the_materialised_matcher(clip, variables, monkeypatch):
    calls = _routes(monkeypatch)
    out = _serve(clip, variables)
    t, r = (torch.from_numpy(x) for x in clip)
    module = DCMCS3DIModule(**SIZES)
    with torch.no_grad():
        want = torch.func.functional_call(module.model, variables, (t, r), {"inference": True})[0]
    assert calls == [] and torch.equal(out, want)
    assert modules.materialised_matcher_fits(t)


def test_valid_w_keeps_the_materialised_matcher(clip, variables, monkeypatch, no_room):
    calls = _routes(monkeypatch)
    module = DCMCS3DIModule(**SIZES)
    t, r = (torch.from_numpy(x[:1]) for x in clip)
    batch = {"target": t, "reference": r}
    padded = module.eval_forward(variables, batch, valid_w=96)
    assert calls == []
    with torch.no_grad():
        want = torch.func.functional_call(module.model, variables, (t, r),
                                          {"inference": True, "valid_w": 96})[0]
    assert torch.equal(padded, want)


@pytest.mark.parametrize("fits", [True, False])
def test_kernel_route_spans_once_a_call(clip, variables, monkeypatch, fits):
    """Either route records the extractor, the attention and the transfer
    net once a frame."""
    monkeypatch.setattr(modules, "materialised_matcher_fits", lambda target: fits)
    profiling.clear()
    profiling.enable()
    try:
        _serve(clip, variables)
        names = [rec.name for rec in profiling.records()]
    finally:
        profiling.disable()
        profiling.clear()
    for name in ("dcmcs3di.extraction", "dcmcs3di.attention", "dcmcs3di.transfer"):
        assert names.count(name) == 2, name  # a frame each, one call a frame
    assert names.count("video.call") == 1


def test_predict_reaches_the_route(tmp_path, clip, monkeypatch, no_room):
    """``predict`` serves through ``eval_forward``: a pair whose volumes do
    not fit takes the row-attention route on float32 operands."""
    from PIL import Image

    from color_transfer_tpu_torch.run import cli

    t, r = clip
    for name, img in (("0000_LD.png", t[0]), ("0000_R.png", r[0])):
        Image.fromarray((img * 255).round().astype(np.uint8)).save(tmp_path / name)
    calls = _routes(monkeypatch)
    out = tmp_path / "corrected.png"
    argv = ["predict", "--method", "dcmcs3di", "--target", str(tmp_path / "0000_LD.png"),
            "--reference", str(tmp_path / "0000_R.png"), "--output", str(out),
            "--device", "cpu", "--model.extraction_layers", "1", "--model.transfer_layers",
            "1", "--model.channels", "16"]
    assert cli.main(argv) == 0 and out.exists()
    assert calls == [True]
