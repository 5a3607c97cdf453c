"""Port parity: color_transfer_tpu_torch.core against color_transfer_tpu.core.

Same numpy inputs through the JAX functions (CPU) and the torch port (CPU).
Tolerance: atol 1e-5 on float outputs (both compute in float32 with the
same source-coordinate arithmetic); index-only ops (nearest resize) and the
integer matcher-size policy must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.core import resize as jresize
from color_transfer_tpu.core import sampling as jsampling
from color_transfer_tpu_torch.core import resize, sampling

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a module's tests. The suite runs in
    several worker processes at once (pytest -n); torch's default of a
    thread per core makes their parallel regions spin against each other,
    and the port's files then run ~5x slower. Other modules import this
    fixture to get the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_hw", [(5, 13), (14, 22), (1, 1), (7, 11)])
def test_resize_bilinear(rng, align_corners, out_hw):
    x = rng.normal(size=(2, 3, 7, 11)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners))
    got = _np(resize.resize_bilinear(torch.from_numpy(x), out_hw, align_corners))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((16, 24), (8, 12)),  # strided branch
                                          ((16, 24), (4, 3)),
                                          ((7, 11), (5, 13)),   # gather branch
                                          ((6, 10), (12, 20))])
def test_resize_nearest(rng, in_hw, out_hw):
    x = rng.normal(size=(2, 1, *in_hw)).astype(np.float32)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    got = _np(resize.resize_nearest(torch.from_numpy(x), out_hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [0.5, 0.25, 2.0])
def test_upsample_flow_bilinear(rng, factor):
    flow = (rng.normal(size=(2, 16, 24, 2)) * 5).astype(np.float32)
    want = np.asarray(jresize.upsample_flow_bilinear(jnp.asarray(flow), factor))
    got = _np(resize.upsample_flow_bilinear(torch.from_numpy(flow), factor))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(1080, 1920), (30, 50), (720, 1280), (1920, 1080),
                                (2160, 3840), (64, 96)])
def test_derive_matcher_size(hw):
    assert resize.derive_matcher_size(*hw) == jresize.derive_matcher_size(*hw)
    if hw == (1080, 1920):
        assert resize.derive_matcher_size(*hw) == (512, 896)


def _flows(rng, b, h, w, scale):
    """Fractional flows with a band of far out-of-image displacements."""
    flow = rng.normal(size=(b, h, w, 2)).astype(np.float32) * scale
    flow[:, : h // 3] += np.float32(3 * max(h, w))
    flow[:, -2:, :, 0] -= np.float32(2 * w)
    return flow


@pytest.mark.parametrize("scale", [0.7, 4.0])
def test_flow_warp_matches_jax(rng, scale):
    feat = rng.normal(size=(2, 9, 13, 5)).astype(np.float32)
    flow = _flows(rng, 2, 9, 13, scale)
    got = _np(sampling.flow_warp(torch.from_numpy(feat), torch.from_numpy(flow)))
    want_vmap = np.asarray(jax.vmap(jsampling.flow_warp)(jnp.asarray(feat),
                                                          jnp.asarray(flow)))
    want_batched = np.asarray(jsampling.flow_warp_batched(jnp.asarray(feat),
                                                          jnp.asarray(flow)))
    np.testing.assert_allclose(got, want_vmap, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_batched, atol=ATOL, rtol=0)


def test_grid_sample_matches_jax(rng):
    img = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    coords = rng.uniform(-4, 12, size=(2, 5, 7, 2)).astype(np.float32)
    got = _np(sampling.grid_sample(torch.from_numpy(img), torch.from_numpy(coords)))
    want = np.asarray(jax.vmap(jsampling.grid_sample)(jnp.asarray(img),
                                                       jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_coords_grid():
    np.testing.assert_array_equal(_np(sampling.coords_grid(5, 7)),
                                  np.asarray(jsampling.coords_grid(5, 7)))


def test_forward_backward_consistency(rng):
    fwd = (rng.normal(size=(2, 12, 16, 2)) * 2).astype(np.float32)
    bwd = (-fwd + rng.normal(size=fwd.shape) * 0.6).astype(np.float32)
    got = sampling.forward_backward_consistency(torch.from_numpy(fwd),
                                                torch.from_numpy(bwd))
    want = jax.vmap(jsampling.forward_backward_consistency)(jnp.asarray(fwd),
                                                            jnp.asarray(bwd))
    for g, w in zip(got, want):
        assert g.shape == (2, 12, 16)
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert 0 < float(g.mean()) < 1  # both classes present


# The two functions no path runs yet: held to JAX within 1e-6.


@pytest.mark.parametrize("mode", ["edge", "constant", "reflect"])
@pytest.mark.parametrize("shape", [(2, 13, 17, 3), (13, 17, 5), (1, 2, 16, 24, 3)])
def test_pad_to_multiple_matches_jax(rng, shape, mode):
    x = rng.normal(size=shape).astype(np.float32)
    want, want_hw = jresize.pad_to_multiple(jnp.asarray(x), 8, mode)
    got, got_hw = resize.pad_to_multiple(torch.from_numpy(x), 8, mode)
    assert got_hw == want_hw == shape[-3:-1]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_and_flow_warp_padding_modes(rng, padding_mode):
    img = rng.normal(size=(12, 20, 4)).astype(np.float32)
    coords = rng.uniform(-6, 26, (7, 9, 2)).astype(np.float32)  # many out of bounds
    want = jsampling.grid_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode)
    got = sampling.grid_sample(torch.from_numpy(img)[None], torch.from_numpy(coords)[None],
                               padding_mode)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    flow = (rng.normal(size=(12, 20, 2)) * 6).astype(np.float32)
    want = jsampling.flow_warp(jnp.asarray(img), jnp.asarray(flow), padding_mode)
    got = sampling.flow_warp(torch.from_numpy(img)[None], torch.from_numpy(flow)[None],
                             padding_mode)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="padding_mode"):
        sampling.grid_sample(torch.from_numpy(img)[None], torch.from_numpy(coords)[None],
                             "reflection")
