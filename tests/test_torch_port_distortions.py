"""Port parity: the photometric distortions
(color_transfer_tpu_torch/data/distortions.py) against
color_transfer_tpu/data/distortions.py.

Lines: each op at fixed factors, the training distortion with the JAX
permutation and factors passed in, and the 31-function grid, all within
1e-5 (float32 on both sides; the blends clamp to [0, 1]). The port's own
draws are checked for their law: a permutation of the 6 ops, factors in
[1 - max, 1 + max], the same draw from the same seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.data import distortions as jd
from color_transfer_tpu_torch.data import distortions as td


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (20, 28, 3)).astype(np.float32)
    img[0, 0] = [0.0, 0.0, 0.0]  # black
    img[0, 1] = [0.4, 0.4, 0.4]  # grey: hue undefined
    img[0, 2] = [1.0, 0.2, 1.0]  # ties in the max
    return img


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("op,factor", [
    ("adjust_brightness", 0.6), ("adjust_brightness", 1.4),
    ("adjust_contrast", 0.55), ("adjust_contrast", 1.45),
    ("adjust_saturation", 0.5), ("adjust_saturation", 1.5),
    ("adjust_hue", -0.4), ("adjust_hue", 0.27),
    ("adjust_gamma", 0.7), ("adjust_gamma", 1.3),
    ("adjust_sharpness", 0.5), ("adjust_sharpness", 1.5),
])
def test_op_at_fixed_factor(image, op, factor):
    got = getattr(td, op)(torch.from_numpy(image), factor)
    _close(got, getattr(jd, op)(jnp.asarray(image), factor))


def test_batched_ops(image):
    """The ops work on (B, H, W, 3) batches as on single images."""
    batch = np.stack([image, image[::-1].copy()])
    for op in ("adjust_contrast", "adjust_sharpness", "adjust_hue"):
        _close(getattr(td, op)(torch.from_numpy(batch), 1.3),
               getattr(jd, op)(jnp.asarray(batch), 1.3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_distortions_with_jax_draw(image, seed):
    key = jax.random.PRNGKey(seed)
    k_perm, k_f = jax.random.split(key)
    perm = np.array(jax.random.permutation(k_perm, 6))
    factors = np.array(jax.random.uniform(k_f, (6,), minval=0.5, maxval=1.5))
    want = jd.apply_uniform_distortions(jnp.asarray(image), key)
    got = td.apply_uniform_distortions(torch.from_numpy(image),
                                       perm=torch.from_numpy(perm),
                                       factors=torch.from_numpy(factors))
    _close(got, want)


def test_uniform_draw_law():
    g = torch.Generator().manual_seed(5)
    perms, factors = zip(*(td.uniform_distortion_draw(g) for _ in range(200)))
    assert all(sorted(p.tolist()) == list(range(6)) for p in perms)
    f = torch.stack(factors)
    assert float(f.min()) >= 0.5 and float(f.max()) <= 1.5
    assert abs(float(f.mean()) - 1.0) < 0.03
    assert len({tuple(p.tolist()) for p in perms}) > 100
    a = td.uniform_distortion_draw(torch.Generator().manual_seed(9))
    b = td.uniform_distortion_draw(torch.Generator().manual_seed(9))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_grid(image):
    got = td.setup_grid_distortions()
    want = jd.setup_grid_distortions()
    assert len(got) == len(want) == 31
    for fg, fw in zip(got, want):
        _close(fg(torch.from_numpy(image)), fw(jnp.asarray(image)))
