"""Port parity for the classical path: core blur / resize_antialias /
colorspace / linalg, the linear methods (Reinhard, CCS, MK), the registry,
the classical branch of color_transfer_between_videos and ``predict``.

The same numpy inputs go through the JAX package (CPU) and the port (CPU).
Tolerances, each stated where it is used:
  * blur and resize_antialias: atol 1e-6 on values in [0, 1] — the same
    taps, summed in the same order, in float32;
  * rgb_to_lab: atol 2e-4 in Lab units (L in 0-100) — torch has no cbrt,
    and pow(1/3) can differ from a correctly rounded cube root by about one
    ulp, which the factors 116 / 500 / 200 scale up; lab_to_rgb: atol 1e-5;
  * cov3 / sqrtm_psd / inv_sqrtm_psd: rtol 1e-4 of the largest entry —
    eigendecompositions by two LAPACK paths;
  * the linear methods: atol 5e-5 on images in [0, 1] — image means and
    covariances summed over the frame in another order, then 3x3 algebra.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu import methods as jmethods
from color_transfer_tpu.core import blur as jblur
from color_transfer_tpu.core import colorspace as jcolor
from color_transfer_tpu.core import linalg as jlinalg
from color_transfer_tpu.core import resize as jresize
from color_transfer_tpu.data import distortions
from color_transfer_tpu.methods import linear as jlinear
from color_transfer_tpu.methods.video import (
    color_transfer_between_videos as jax_videos,
)
from color_transfer_tpu.parallel import create_mesh
from color_transfer_tpu_torch import methods
from color_transfer_tpu_torch.core import blur, colorspace, linalg, resize
from color_transfer_tpu_torch.methods import linear
from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
from color_transfer_tpu_torch.run import cli

METHOD_ATOL = 5e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(rng, h=48, w=64):
    """Structured content (anisotropic covariances) and a shifted, darkened
    reference — the JAX package's oracle-test pair (tests/test_methods.py)."""
    base = rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    gradient = np.linspace(0, 0.3, w)[None, :, None]
    gt = np.clip(base * 0.7 + gradient, 0, 1).astype(np.float32)
    ref = np.clip(np.roll(gt, 5, axis=1) * 0.95 + 0.02, 0, 1).astype(np.float32)
    return gt, ref


DISTORTIONS = {
    "none": lambda x: x,
    "hue": lambda x: distortions.adjust_hue(x, 0.2),
    "saturation": lambda x: distortions.adjust_saturation(x, 1.3),
    "contrast": lambda x: distortions.adjust_contrast(x, 0.6),
}


@pytest.mark.parametrize("kernel_size,sigma", [(5, 0.5), ((5, 9), (0.5, 1.3)),
                                               (11, 2.0), (25, 3.0)])
@pytest.mark.parametrize("channel_last", [False, True])
def test_gaussian_blur(rng, kernel_size, sigma, channel_last):
    """(25, 25) exceeds JAX's 512-tap shift-add limit: JAX convolves, the
    port keeps shifting; the sums agree to rounding."""
    x = rng.uniform(0, 1, (2, 3, 30, 37)).astype(np.float32)
    if channel_last:
        x = np.moveaxis(x, 1, -1)
    want = np.asarray(jblur.gaussian_blur(jnp.asarray(x), kernel_size, sigma,
                                          channel_last=channel_last))
    got = blur.gaussian_blur(_t(x), kernel_size, sigma, channel_last=channel_last)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_gaussian_kernel_and_sigma_only(rng):
    np.testing.assert_allclose(blur.gaussian_kernel1d(7, 1.5).numpy(),
                               np.asarray(jblur.gaussian_kernel1d(7, 1.5)), atol=1e-7)
    x = rng.uniform(0, 1, (20, 26, 3)).astype(np.float32)
    want = np.asarray(jblur.gaussian_blur_sigma_only(jnp.asarray(x), 0.8,
                                                     channel_last=True))
    got = blur.gaussian_blur_sigma_only(_t(x), 0.8, channel_last=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((96, 128), (48, 64)), ((45, 61), (23, 31)),
                                          ((34, 60), (17, 30)), ((20, 30), (40, 45)),
                                          ((30, 40), (30, 20))])
def test_resize_antialias(rng, in_hw, out_hw):
    x = rng.uniform(0, 1, (2, 3, *in_hw)).astype(np.float32)
    want = np.asarray(jresize.resize_antialias(jnp.asarray(x), out_hw))
    got = resize.resize_antialias(_t(x), out_hw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_lab_both_ways(rng):
    # Include the dark range below the sRGB and Lab thresholds.
    rgb = np.concatenate([rng.uniform(0, 1, (500, 3)), rng.uniform(0, 0.01, (100, 3))])
    rgb = rgb.astype(np.float32)
    want = np.asarray(jcolor.rgb_to_lab(jnp.asarray(rgb)))
    got = colorspace.rgb_to_lab(_t(rgb))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    back = np.asarray(jcolor.lab_to_rgb(jnp.asarray(want)))
    np.testing.assert_allclose(colorspace.lab_to_rgb(_t(want)).numpy(), back,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(colorspace.xyz_to_rgb(colorspace.rgb_to_xyz(_t(rgb))).numpy(),
                               rgb, atol=1e-5)


def test_linalg(rng):
    x = (rng.normal(size=(2, 400, 3)) @ rng.normal(size=(3, 3))).astype(np.float32)
    for i in range(2):
        want_cov = np.asarray(jlinalg.cov3(jnp.asarray(x[i])))
        got_cov = linalg.cov3(_t(x))[i].numpy()
        np.testing.assert_allclose(got_cov, want_cov, rtol=0,
                                   atol=1e-5 * np.abs(want_cov).max())
        np.testing.assert_allclose(got_cov, np.cov(x[i].T), rtol=0,
                                   atol=1e-4 * np.abs(want_cov).max())
        for jfn, fn in ((jlinalg.sqrtm_psd, linalg.sqrtm_psd),
                        (jlinalg.inv_sqrtm_psd, linalg.inv_sqrtm_psd)):
            want = np.asarray(jfn(jnp.asarray(want_cov)))
            got = fn(_t(want_cov)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    c = _t(want_cov)
    s = linalg.sqrtm_psd(c)
    np.testing.assert_allclose((s @ s).numpy(), want_cov, atol=1e-4 * np.abs(want_cov).max())
    b = _t(rng.normal(size=(3, 2)).astype(np.float32))
    np.testing.assert_allclose((c @ linalg.solve3(c, b)).numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("distortion", sorted(DISTORTIONS))
@pytest.mark.parametrize("name,kwargs", [
    ("reinhard", {}),
    ("correlated_color_space", {}),
    ("monge_kantorovitch", {"decomposition": "MK"}),
    ("monge_kantorovitch", {"decomposition": "sqrt"}),
    ("monge_kantorovitch", {"decomposition": "cholesky"}),
])
def test_linear_methods_match_jax(rng, name, kwargs, distortion):
    gt, ref = _scene(rng)
    target = np.asarray(DISTORTIONS[distortion](jnp.asarray(gt)))
    want = np.asarray(getattr(jlinear, name)(jnp.asarray(target), jnp.asarray(ref), **kwargs))
    got = getattr(linear, name)(_t(target), _t(ref), **kwargs)
    assert got.shape == target.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=METHOD_ATOL, rtol=0)


def test_linear_batched_forms_and_errors(rng):
    """The batched form on a chunk equals the per-image form frame by frame
    (per-frame references, and one reference for every frame)."""
    t = rng.uniform(0.1, 0.9, (3, 16, 20, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.9, (3, 12, 18, 3)).astype(np.float32)
    for fn in (linear.reinhard, linear.correlated_color_space, linear.monge_kantorovitch):
        chunk = fn.batched(_t(t), _t(r))
        single = fn.batched(_t(t), _t(r[:1]))
        for i in range(3):
            torch.testing.assert_close(chunk[i], fn(_t(t[i]), _t(r[i])), atol=1e-6, rtol=0)
            torch.testing.assert_close(single[i], fn(_t(t[i]), _t(r[0])), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        linear.monge_kantorovitch(_t(t[0]), _t(r[0]), decomposition="svd")


def test_align_axes_and_eig_order():
    c = torch.tensor([[4.0, 1.0, 0.0], [1.0, 3.0, 0.0], [0.0, 0.0, 1.0]])
    vals, vecs = linear._sorted_eig_desc(c)
    assert torch.all(vals[:-1] >= vals[1:])
    flipped = linear._align_axes(-vecs, vecs)
    torch.testing.assert_close(flipped, vecs)


def test_registry_matches_jax():
    """Every name and alias of the JAX registry resolves, to the same method
    (by name), and so do the reference's dotted func_spec tails."""
    assert methods.available_methods() == jmethods.available_methods()
    for name in jmethods.available_methods():
        assert methods.get_method(name).__name__ == jmethods.get_method(name).__name__
    assert methods.get_method("methods.linear.color_transfer_between_images") is linear.reinhard
    assert methods.get_method("idt") is methods.iterative.iterative_distribution_transfer
    with pytest.raises(KeyError):
        methods.get_method("nope")
    with pytest.raises(ValueError):
        methods.register("idt", linear.reinhard)


@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("method", ["monge_kantorovitch", "reinhard"])
def test_video_matches_jax(rng, method, per_frame):
    """Per-frame and global mode against the JAX entry point (one-device
    mesh) on a clip longer than one chunk; clipped outputs, METHOD_ATOL."""
    t = rng.uniform(0.2, 0.8, (5, 16, 24, 3)).astype(np.float32)
    r = np.clip(t[:, :, ::-1] * 0.8 + 0.1, 0, 1).astype(np.float32)
    mesh = create_mesh(devices=jax.devices()[:1])
    want = np.asarray(jax_videos(t, r, method=method, batch_size=2, mesh=mesh,
                                 per_frame=per_frame))
    got = color_transfer_between_videos(t, r, method=method, batch_size=2, device="cpu",
                                        per_frame=per_frame)
    assert got.shape == t.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=METHOD_ATOL, rtol=0)


def test_video_default_is_classical(rng):
    """The default method is monge_kantorovitch and the default chunk 8
    frames; a method without a batched form runs frame by frame."""
    t = rng.uniform(0.2, 0.8, (10, 8, 12, 3)).astype(np.float32)
    r = np.clip(t * 0.9 + 0.05, 0, 1).astype(np.float32)
    out = color_transfer_between_videos(t, r, device="cpu")
    want = linear.monge_kantorovitch.batched(_t(t), _t(r)).clamp(0, 1)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
    name = "_test_unbatched_mk"
    methods.register(name, lambda a, b: linear.monge_kantorovitch(a, b))
    try:
        loop = color_transfer_between_videos(t, r, method=name, device="cpu",
                                             per_frame=False)
    finally:
        methods._REGISTRY.pop(name)
    glob = color_transfer_between_videos(t, r, device="cpu", per_frame=False)
    torch.testing.assert_close(loop, glob, atol=1e-6, rtol=0)


def _write_png(path, img):
    from PIL import Image

    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def test_cli_predict_classical(tmp_path, rng, capsys):
    """``predict --method monge_kantorovitch`` on the CPU writes the MK of
    the PNG pair (8-bit rounding: within half a level plus METHOD_ATOL);
    --ckpt_path on a parameterless method warns and is ignored."""
    from PIL import Image

    gt, ref = _scene(rng, 24, 32)
    _write_png(tmp_path / "0000_LD.png", gt)
    _write_png(tmp_path / "0000_R.png", ref)
    out = tmp_path / "out" / "c.png"
    with pytest.warns(UserWarning, match="parameterless"):
        rc = cli.main(["predict", "--method", "monge_kantorovitch",
                       "--target", str(tmp_path / "0000_LD.png"),
                       "--reference", str(tmp_path / "0000_R.png"),
                       "--output", str(out), "--device", "cpu",
                       "--ckpt_path", "ckpt/best"])
    assert rc == 0 and str(out) in capsys.readouterr().out
    t8 = np.asarray(Image.open(tmp_path / "0000_LD.png"), np.float32) / 255
    r8 = np.asarray(Image.open(tmp_path / "0000_R.png"), np.float32) / 255
    want = np.clip(np.asarray(jlinear.monge_kantorovitch(jnp.asarray(t8), jnp.asarray(r8))), 0, 1)
    got = np.asarray(Image.open(out), np.float32) / 255
    assert np.abs(got - want).max() <= 0.5 / 255 + METHOD_ATOL
    assert Path(out).exists()
