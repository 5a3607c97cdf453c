"""Port parity: the warp adjoint (color_transfer_tpu_torch/ops/warp_adjoint.py,
the plain version of kernel B7) and ``flow_warp_batched`` as an autograd
Function (core/sampling.py) against color_transfer_tpu/core/sampling.py.

Lines: the padded and cropped scatter within atol 1e-5 of ``_adjoint_warp_xla``
and of ``_adjoint_warp_pallas(interpret=True)`` (f32 sums of up to four
updates per corner in another order); the feature cotangent within 1e-5 of
``jax.grad`` of ``flow_warp_batched``; the flow cotangent within 1e-4 on
interior flows (clamped samples have a subgradient choice); zero cotangent
for samples far outside; ``torch.autograd.gradcheck`` in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.core import sampling as jsampling
from color_transfer_tpu_torch.core.sampling import flow_warp, flow_warp_batched
from color_transfer_tpu_torch.ops import warp_adjoint as wa


def _data(b, h, w, c, mag, seed):
    rng = np.random.default_rng(seed)
    feat = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    flow = (rng.normal(size=(b, h, w, 2)) * mag).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return feat, flow, g


def _jax_padded_scatter(flow, g):
    b, h, w, c = g.shape
    _, _, starts, wx, wy = jsampling._warp_geometry(jnp.asarray(flow), h, w)
    corner_w = jnp.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy],
                         axis=-1)
    xla = jsampling._adjoint_warp_xla(starts, corner_w, jnp.asarray(g))
    pallas = jsampling._adjoint_warp_pallas(starts, wx, wy, jnp.asarray(g),
                                            interpret=True)
    return np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("shape,mag", [((2, 16, 7, 3), 4.0), ((1, 8, 12, 5), 1.0),
                                       ((2, 8, 9, 4), 12.0)])
def test_plain_scatter_matches_xla_and_pallas(shape, mag):
    """The plain version's padded buffer against both JAX scatters (Pallas
    needs H % 8 == 0, as its callers guarantee); the port's crop is the JAX
    backward's."""
    b, h, w, c = shape
    _, flow, g = _data(*shape, mag, seed=1)
    xla, pallas = _jax_padded_scatter(flow, g)
    got = wa.warp_adjoint_plain(torch.from_numpy(g), torch.from_numpy(flow)).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, xla[:, 2 : 2 + h, 2 : 2 + w], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas[:, 2 : 2 + h, 2 : 2 + w], atol=1e-5, rtol=0)


def test_corners_match_jax_geometry():
    _, flow, _ = _data(2, 9, 11, 1, 5.0, seed=2)
    _, _, starts, wx, wy = jsampling._warp_geometry(jnp.asarray(flow), 9, 11)
    rows, weights = wa.warp_corners(torch.from_numpy(flow), 9, 11)
    starts = np.asarray(starts)
    want_rows = ((np.arange(2)[:, None, None] * 13 + starts[..., 0]) * 15 + starts[..., 1])
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_allclose(weights[..., 1].numpy(),
                               np.asarray(wx * (1 - wy)), atol=1e-7, rtol=0)


@pytest.mark.parametrize("mag", [5.0, 40.0])
def test_feature_cotangent_matches_jax_grad(mag):
    feat, flow, g = _data(2, 9, 11, 5, mag, seed=3)

    def loss(f):
        return jnp.sum(jsampling.flow_warp_batched(f, jnp.asarray(flow)) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_(True)
    out = flow_warp_batched(f, torch.from_numpy(flow))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, atol=1e-5, rtol=0)


def test_flow_cotangent_matches_jax_grad():
    """Interior samples (|flow| ~ 1 on a 9 x 11 image)."""
    feat, flow, g = _data(2, 9, 11, 5, 1.0, seed=4)

    def loss(fl):
        return jnp.sum(jsampling.flow_warp_batched(jnp.asarray(feat), fl) * g)

    want = np.asarray(jax.grad(loss)(jnp.asarray(flow)))
    fl = torch.from_numpy(flow).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    (flow_warp_batched(f, fl) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(fl.grad.numpy(), want, atol=1e-4, rtol=1e-4)


def test_forward_matches_jax_and_flow_warp():
    feat, flow, _ = _data(2, 9, 11, 5, 3.0, seed=5)
    want = np.asarray(jsampling.flow_warp_batched(jnp.asarray(feat), jnp.asarray(flow)))
    got = flow_warp_batched(torch.from_numpy(feat), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(got, flow_warp(torch.from_numpy(feat), torch.from_numpy(flow)))


def test_out_of_bounds_cotangent_is_zero():
    feat, _, g = _data(2, 9, 11, 5, 0.0, seed=6)
    flow = torch.full((2, 9, 11, 2), 1000.0)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = flow_warp_batched(f, flow)
    assert float(out.detach().abs().max()) == 0.0
    (out * torch.from_numpy(g)).sum().backward()
    assert float(f.grad.abs().max()) == 0.0


def test_no_flow_cotangent_unless_needed(monkeypatch):
    """A flow without grad (DMSCT's frozen matcher) takes only the scatter."""
    feat, flow, _ = _data(1, 8, 8, 3, 2.0, seed=7)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = flow_warp_batched(f, torch.from_numpy(flow))
    calls = []  # the flow branch re-gathers the corners; the scatter does not
    monkeypatch.setattr("color_transfer_tpu_torch.core.sampling._corners",
                        lambda *a: calls.append(1))
    out.sum().backward()
    assert calls == [] and f.grad is not None


def test_gradcheck_float64():
    rng = np.random.default_rng(8)
    feat = torch.from_numpy(rng.uniform(0, 1, (1, 4, 5, 2))).requires_grad_(True)
    # Fractional positions away from integer corners and from the clamp
    # bounds, so the finite differences stay on one bilinear piece.
    flow = torch.from_numpy(rng.uniform(0.2, 0.8, (1, 4, 5, 2))
                            * rng.choice([-1.0, 1.0], (1, 4, 5, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(flow_warp_batched, (feat, flow), eps=1e-6, atol=1e-6)


def test_wrapper_routes_cpu_to_plain():
    _, flow, g = _data(1, 8, 8, 3, 2.0, seed=9)
    before = wa.warp_adjoint.launches
    got = wa.warp_adjoint(torch.from_numpy(g), torch.from_numpy(flow))
    want = wa.warp_adjoint_plain(torch.from_numpy(g), torch.from_numpy(flow))
    assert torch.equal(got, want) and wa.warp_adjoint.launches == before
    with pytest.raises(ValueError):
        wa.check_kernel_inputs(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 5, 2))
    with pytest.raises(ValueError):
        wa.check_kernel_inputs(torch.zeros(1, 4, 4, 3, dtype=torch.float64),
                               torch.zeros(1, 4, 4, 2))
