"""Port parity: the offline dataset tool
(color_transfer_tpu_torch/tools/postprocess.py) against
color_transfer_tpu/tools/postprocess.py — SIFT's homography, the LoFTR
request's fallback without kornia, and a whole synthetic sample (three
mp4v videos and params.json) written by both tools, held within 1 LSB
(the Monge-Kantorovitch alignment rounds to uint8 on each side)."""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from color_transfer_tpu.tools import postprocess as jpp  # noqa: E402
from color_transfer_tpu_torch.tools import postprocess as tpp  # noqa: E402

H, W = 120, 160


def _scene(rng, h, w):
    base = (rng.uniform(0, 1, (h // 4, w // 4, 3)) > 0.5).astype(np.uint8) * 255
    base = cv2.resize(base, (w, h), interpolation=cv2.INTER_NEAREST)
    return cv2.GaussianBlur(base, (5, 5), 1.2)


def _write_sample(root, frames=5):
    """A textured scene drifting right: left_gt the scene, left its mirror
    image (the rig's mirror view), right a warped, colour-cast copy. The
    right video starts one frame late (its offset)."""
    rng = np.random.default_rng(3)
    world = _scene(rng, H, W + 2 * frames + 2)
    h_right = np.array([[1.01, 0.01, 3.0], [-0.01, 0.99, -2.0], [0.0, 0.0, 1.0]])
    writers = {name: cv2.VideoWriter(str(root / f"{name}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
               for name in tpp.VIEWS}
    for name, w in writers.items():
        if not w.isOpened():
            pytest.skip("OpenCV cannot write mp4v here")
    for t in range(frames + 1):
        gt = np.ascontiguousarray(world[:, 2 * t:2 * t + W])
        right = cv2.warpPerspective(gt, h_right, (W, H))
        right = np.clip(right.astype(np.float32) * [0.9, 1.0, 1.1] + 6, 0, 255).astype(np.uint8)
        writers["left"].write(cv2.flip(gt, 1))
        writers["left_gt"].write(gt)
        writers["right"].write(right)
    for w in writers.values():
        w.release()
    (root / "params.json").write_text(json.dumps({
        "bbox": {"x": 8, "y": 6, "w": W - 24, "h": H - 20},
        "offsets": {"all": 0, "left": 0, "left_gt": 0, "right": 1}}))


def test_sift_recovers_known_transform():
    rng = np.random.default_rng(0)
    base = (rng.uniform(0, 1, (240, 320)) > 0.5).astype(np.uint8) * 255
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    img = cv2.merge([base, base, base])
    h_true = np.array([[1.02, 0.01, 4.0], [-0.015, 0.99, -3.0], [1e-5, -2e-5, 1.0]])
    warped = cv2.warpPerspective(img, h_true, (320, 240))
    h_est = tpp.estimate_homography(warped, img)
    pts = np.array([[60, 60], [260, 60], [160, 180]], dtype=np.float32)
    back = cv2.perspectiveTransform(cv2.perspectiveTransform(pts[None], h_true), h_est)[0]
    assert np.abs(back - pts).max() < 1.5
    np.testing.assert_array_equal(h_est, jpp.estimate_homography(warped, img))


def test_loftr_without_kornia_falls_back_to_sift(capsys):
    pytest.importorskip("torch")
    try:
        import kornia  # noqa: F401
        pytest.skip("kornia is installed: the fallback does not run")
    except ImportError:
        pass
    rng = np.random.default_rng(1)
    img = _scene(rng, 160, 200)
    shifted = np.ascontiguousarray(np.roll(img, 5, axis=1))
    got = tpp.estimate_homography(shifted, img, method="LOFTR")
    assert "falling back to SIFT" in capsys.readouterr().out
    np.testing.assert_array_equal(got, tpp.estimate_homography(shifted, img))


def test_process_sample_matches_jax(tmp_path):
    sample = tmp_path / "raw" / "s0"
    sample.mkdir(parents=True)
    _write_sample(sample)
    jpp.process_sample(sample, tmp_path / "jax", rate=2, num_frames=2)
    written = tpp.process_sample(sample, tmp_path / "torch", rate=2, num_frames=2,
                                 device="cpu")
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == sorted(p.name for p in written) == [
        f"{i:04d}_{s}.png" for i in range(2) for s in ("L", "LD", "R")]
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / name)).astype(int)
        got = cv2.imread(str(tmp_path / "torch" / name)).astype(int)
        # The second crop truncates the first by (y, x) (the reference's quirk).
        assert got.shape == want.shape == (H - 20 - 6, W - 24 - 8, 3)
        if name.endswith(("_L.png", "_LD.png")):
            np.testing.assert_array_equal(got, want)  # crops and warps: OpenCV on both
        else:
            assert np.abs(got - want).max() <= 1, name


def test_cli_writes_each_sample(tmp_path):
    sample = tmp_path / "raw" / "s0"
    sample.mkdir(parents=True)
    _write_sample(sample)
    rc = tpp.main(["--root", str(tmp_path / "raw"), "--output", str(tmp_path / "out"),
                   "--rate", "2", "--frames", "1", "--device", "cpu"])
    assert rc == 0
    assert sorted(p.name for p in (tmp_path / "out" / "s0").glob("*.png")) == [
        "0000_L.png", "0000_LD.png", "0000_R.png"]
