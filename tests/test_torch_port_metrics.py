"""Port parity: the quality metrics (color_transfer_tpu_torch/metrics) and the
colour spaces they use against color_transfer_tpu on the same images.

Lines: psnr, ssim, ssim_loss within 1e-5 (float32 on both sides, sums in
another order); icid and fsim within 1e-4 (Lab's cube root and the FFTs
round differently); the colour conversions within 1e-5. Shapes include
(1, 384, 392): min(H, W) / 256 rounds to 2, so piq's and iCID's
downsampling and FSIM's pooling run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu import metrics as JM
from color_transfer_tpu.core import colorspace as jcs
from color_transfer_tpu.core.resize import avg_pool2d as j_avg_pool2d
from color_transfer_tpu_torch import metrics as M
from color_transfer_tpu_torch.core import colorspace as cs
from color_transfer_tpu_torch.core.resize import avg_pool2d
from color_transfer_tpu_torch.run.modules import quality_metrics
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

SHAPES = [(2, 32, 48), (1, 384, 392)]


def _pair(b, h, w, seed=0):
    """A smooth image and a distorted, noisy copy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy - c) for c in range(3)], -1)
    x = np.clip(0.5 + 0.35 * base + 0.05 * rng.normal(size=(b, h, w, 3)), 0, 1)
    y = np.clip(x * 0.9 + 0.05 + 0.03 * rng.normal(size=x.shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def _both(fn_t, fn_j, x, y, **kw):
    got = float(fn_t(torch.from_numpy(x), torch.from_numpy(y), **kw))
    want = float(fn_j(jnp.asarray(x), jnp.asarray(y), **kw))
    return got, want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["psnr", "ssim", "ssim_loss"])
def test_basic_metrics(shape, name):
    x, y = _pair(*shape)
    got, want = _both(getattr(M, name), getattr(JM, name), x, y)
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_icid(shape):
    x, y = _pair(*shape, seed=1)
    got, want = _both(M.icid, JM.icid, x, y)
    assert abs(got - want) <= 1e-4, (got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_fsim(shape):
    x, y = _pair(*shape, seed=2)
    got, want = _both(M.fsim, JM.fsim, x, y)
    assert abs(got - want) <= 1e-4, (got, want)
    got, want = _both(M.fsim, JM.fsim, x, y, chromatic=False)
    assert abs(got - want) <= 1e-4, (got, want)


def test_identical_images():
    x, _ = _pair(1, 40, 56, seed=3)
    t = torch.from_numpy(x)
    assert float(M.ssim(t, t)) == pytest.approx(1.0, abs=1e-5)
    assert float(M.ssim_loss(t, t)) == pytest.approx(0.0, abs=1e-6)
    assert float(M.icid(t, t)) == pytest.approx(0.0, abs=1e-5)
    assert float(M.fsim(t, t)) == pytest.approx(1.0, abs=1e-5)


def test_ssim_loss_gradient():
    """The training loss's gradient against jax.grad of the JAX loss."""
    import jax

    x, y = _pair(2, 24, 40, seed=4)
    want = np.asarray(jax.grad(lambda a: JM.ssim_loss(a, jnp.asarray(y)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    M.ssim_loss(t, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("fn", ["rgb_to_hsv", "rgb_to_grayscale", "rgb_to_yiq"])
def test_colorspace(fn):
    x, _ = _pair(1, 16, 24, seed=5)
    x[0, 0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [0.2, 0.9, 0.9]]  # grey, black, ties
    got = getattr(cs, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jcs, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hsv_round_trip_matches_jax():
    rng = np.random.default_rng(6)
    hsv = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    hsv[:6, 0] = np.arange(6) / 6.0  # sector boundaries
    got = cs.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcs.hsv_to_rgb(jnp.asarray(hsv))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_avg_pool2d(factor):
    x = np.random.default_rng(7).normal(size=(2, 3, 13, 17)).astype(np.float32)
    np.testing.assert_allclose(avg_pool2d(torch.from_numpy(x), factor).numpy(),
                               np.asarray(j_avg_pool2d(jnp.asarray(x), factor)),
                               atol=1e-6, rtol=0)


def test_quality_metrics_names():
    x, y = _pair(1, 32, 48, seed=8)
    vals = quality_metrics(torch.from_numpy(x), torch.from_numpy(y), "Training ")
    assert sorted(vals) == ["Training FSIM", "Training PSNR", "Training SSIM",
                            "Training iCID"]
    assert sorted(quality_metrics(torch.from_numpy(x), torch.from_numpy(y),
                                  heavy=False)) == ["PSNR", "SSIM", "iCID"]
