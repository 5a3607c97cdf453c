"""Port parity: the native image decoder (color_transfer_tpu_torch/
data/native_loader.py) — tests/test_native_loader.py's cases against the
port, byte equality with the JAX package's binding on the same files, the
PIL fallback, the build's place and error, and the datasets' crops through
the cropped decode against the whole-image PIL decode they replaced and
against the JAX package's datasets. Every line is exact: both sides decode
the same bytes with the same libraries.
"""

import numpy as np
import pytest
from PIL import Image

from color_transfer_tpu.data import datasets as jdatasets
from color_transfer_tpu.data import native_loader as jnative
from color_transfer_tpu_torch.data import datasets, native_loader


@pytest.fixture
def png_path(tmp_path, rng):
    arr = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path)
    return path, arr


@pytest.fixture
def pil_only(monkeypatch):
    """The loader as it runs when the build failed."""
    monkeypatch.setattr(native_loader, "_lib", False)
    monkeypatch.setattr(native_loader, "_error", "no compiler")


def test_available():
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.build_error() is None


def test_builds_into_the_port_not_native(tmp_path):
    lib = native_loader._build()
    assert lib.parent == native_loader.BUILD_DIR
    assert lib.parent.name == "_build" and lib.parent.parent.name == "color_transfer_tpu_torch"
    assert native_loader.SOURCE.name == "imageio.cc" and native_loader.SOURCE.parent.name == "native"


def test_build_failure_falls_back_to_pil(monkeypatch, tmp_path, png_path):
    path, arr = png_path
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native_loader.available()
    assert "no-such-compiler" in native_loader.build_error()
    np.testing.assert_array_equal(native_loader.read_image(path), arr)
    np.testing.assert_array_equal(native_loader.read_image_crop(path, 5, 7, 16, 20),
                                  arr[5:21, 7:27])
    assert native_loader.image_info(path) == arr.shape[:2]


def test_info(png_path):
    path, arr = png_path
    assert native_loader.image_info(path) == arr.shape[:2]


def test_decode_matches_pil(png_path):
    path, arr = png_path
    np.testing.assert_array_equal(native_loader.read_image(path), arr)


def test_crop_decode(png_path):
    path, arr = png_path
    got = native_loader.read_image_crop(path, 5, 7, 16, 20)
    np.testing.assert_array_equal(got, arr[5:21, 7:27])


def test_jpeg_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    path = tmp_path / "img.jpg"
    Image.fromarray(arr).save(path, quality=95)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(native_loader.read_image(path), want)


def test_grayscale_png_promoted(tmp_path, rng):
    arr = rng.integers(0, 255, (12, 14), dtype=np.uint8)
    path = tmp_path / "gray.png"
    Image.fromarray(arr, mode="L").save(path)
    got = native_loader.read_image(path)
    assert got.shape == (12, 14, 3)
    for c in range(3):
        np.testing.assert_array_equal(got[..., c], arr)


def test_rgba_png_stripped(tmp_path, rng):
    arr = rng.integers(0, 255, (10, 11, 4), dtype=np.uint8)
    path = tmp_path / "rgba.png"
    Image.fromarray(arr, mode="RGBA").save(path)
    np.testing.assert_array_equal(native_loader.read_image(path), arr[..., :3])


def test_bounds_error(png_path):
    path, _ = png_path
    with pytest.raises(IOError):
        native_loader.read_image_crop(path, 30, 50, 16, 20)


def test_missing_file(tmp_path):
    with pytest.raises(IOError):
        native_loader.read_image(tmp_path / "nope.png")


@pytest.mark.parametrize("kind", ["png", "jpg", "gray", "rgba"])
def test_bytes_equal_to_jax_binding(tmp_path, rng, kind):
    """The port's and the JAX package's bindings give the same bytes (whole
    and cropped) on the same file."""
    shape = {"gray": (29, 41), "rgba": (29, 41, 4)}.get(kind, (29, 41, 3))
    arr = rng.integers(0, 255, shape, dtype=np.uint8)
    path = tmp_path / f"img.{'jpg' if kind == 'jpg' else 'png'}"
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(native_loader.read_image(path), jnative.read_image(path))
    np.testing.assert_array_equal(native_loader.read_image_crop(path, 3, 4, 20, 30),
                                  jnative.read_image_crop(path, 3, 4, 20, 30))
    assert native_loader.image_info(path) == jnative.image_info(path)


def _pairs(root, rng, n=3, hw=(40, 56)):
    root.mkdir()
    for i in range(n):
        for view in ("L", "R"):
            arr = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / f"{i:04d}_{view}.png")
    return root


def _pil_crop_sample(ds, index, epoch):
    """The datasets' crop as it was cut before the cropped decode: the same
    SeedSequence((seed, epoch, index)) draws on a whole PIL decode."""
    rng = np.random.default_rng(np.random.SeedSequence(entropy=(ds.seed, epoch, index)))
    gt_path, ref_path = ds.gts[index // ds.image_repeats], ds.references[index // ds.image_repeats]
    ch, cw = ds.crop_size
    with Image.open(gt_path) as img:
        h, w = img.height, img.width
    top, left = int(rng.integers(0, h - ch + 1)), int(rng.integers(0, w - cw + 1))
    read = lambda p: np.asarray(Image.open(p).convert("RGB"))  # noqa: E731
    gt = read(gt_path)[top : top + ch, left : left + cw]
    reference = read(ref_path)[top : top + ch, left : left + cw]
    if rng.random() > 0.5:
        gt, reference = reference[:, ::-1], gt[:, ::-1]
    if rng.random() > 0.5:
        gt, reference = gt[::-1], reference[::-1]
    return gt, reference


@pytest.mark.parametrize("epoch", [0, 3])
def test_train_crops_bit_identical(tmp_path, rng, epoch):
    """Every crop and flip of two epochs: the cropped native decode equals
    the whole PIL decode it replaced, the PIL fallback, and the JAX
    package's dataset."""
    root = _pairs(tmp_path / "Train", rng)
    ours = datasets.ArtificialTrainValDataset(root, (17, 23), image_repeats=2, seed=5)
    ref = jdatasets.ArtificialTrainValDataset(root, (17, 23), image_repeats=2, seed=5)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        want = _pil_crop_sample(ours, i, epoch)
        for j, k in enumerate(("gt", "reference")):
            np.testing.assert_array_equal(a[k], want[j])
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].flags.c_contiguous


def test_train_crops_same_through_fallback(tmp_path, rng, pil_only):
    root = _pairs(tmp_path / "Train", rng)
    ours = datasets.ArtificialTrainValDataset(root, (40, 56), seed=2)
    for i in range(len(ours)):
        want = _pil_crop_sample(ours, i, 0)
        np.testing.assert_array_equal(ours[i]["gt"], want[0])
        np.testing.assert_array_equal(ours[i]["reference"], want[1])


def test_test_sets_decode_natively(tmp_path, rng, monkeypatch):
    """The test sets read whole images through the native decoder."""
    root = _pairs(tmp_path / "Test", rng, n=1)
    calls = []
    monkeypatch.setattr(datasets, "read_image",
                        lambda p: calls.append(p) or native_loader.read_image(p))
    item = datasets.ArtificialTestDataset(root)[0]
    assert len(calls) == 2
    with Image.open(root / "0000_L.png") as img:
        np.testing.assert_array_equal(item["gt"], np.asarray(img.convert("RGB")))
