"""Port parity: UniMatch's stereo and depth branches
(color_transfer_tpu_torch/models/gmflow_extras.py) and the transformer's
``attn_type`` routing (models/gmflow.py::FeatureTransformer) against
color_transfer_tpu, case by case of tests/test_gmflow_extras.py: the same
numpy inputs through JAX's function and the port's.

Lines (f32 on both sides, sums in another order): 1e-5 of max(1, max|ref|)
for attention, correlation probabilities and geometry; disparity and depth
1e-4 of their scale (an expectation over up to W candidates); the
transformer's features 1e-4 of scale (two layers of 128 channels, the
stage line of test_torch_port_gmflow.py); the masks and the argmax depth
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu.models import gmflow as jg
from color_transfer_tpu.models import gmflow_extras as jx
from color_transfer_tpu.tools.convert_gmflow import convert_state_dict
from color_transfer_tpu_torch.models import gmflow as tg
from color_transfer_tpu_torch.models import gmflow_extras as tx
from color_transfer_tpu_torch.run.modules import random_state_dict
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

TIGHT, LOOSE = 1e-5, 1e-4
ATTN_TYPES = ["swin", "self_swin2d_cross_1d", "self_swin2d_cross_swin1d"]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, line=TIGHT):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= line * max(1.0, float(np.abs(want).max())), err


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _intrinsics(fx=20.0, fy=18.0, cx=7.5, cy=3.5):
    return np.asarray([[[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]], dtype=np.float32)


# -- 1D attention --------------------------------------------------------------


def test_full_attention_1d(rng):
    b, h, w, c = 2, 3, 8, 16
    q, k, v = (_normal(rng, b, h * w, c) for _ in range(3))
    got = tx.full_attention_1d(_t(q), _t(k), _t(v), h, w)
    _close(got, jx.full_attention_1d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, w))


@pytest.mark.parametrize("with_shift", [False, True])
def test_swin_attention_1d(rng, with_shift):
    b, h, w, c = 1, 2, 16, 8
    q, k, v = (_normal(rng, b, h * w, c) for _ in range(3))
    got = tx.swin_attention_1d(_t(q), _t(k), _t(v), 2, with_shift, h, w)
    want = jx.swin_attention_1d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                                with_shift, h, w)
    _close(got, want)


@pytest.mark.parametrize("w,k", [(16, 2), (24, 3), (32, 4)])
def test_shift_window_mask_1d(w, k):
    np.testing.assert_array_equal(tx._shift_window_mask_1d(w, k), jx._shift_window_mask_1d(w, k))


# -- stereo correlation ----------------------------------------------------------


def test_global_correlation_softmax_stereo(rng):
    b, h, w, c = 1, 4, 32, 32
    f0 = _normal(rng, b, h, w, c, scale=8)
    f1 = np.roll(f0, shift=-3, axis=2)
    disp, prob = tx.global_correlation_softmax_stereo(_t(f0), _t(f1))
    jdisp, jprob = jx.global_correlation_softmax_stereo(jnp.asarray(f0), jnp.asarray(f1))
    _close(prob, jprob)
    _close(disp, jdisp, LOOSE)
    np.testing.assert_allclose(disp.numpy()[:, :, 5:-2], 3, atol=0.2)
    assert float(disp.min()) > -0.5


@pytest.mark.parametrize("radius", [1, 4])
def test_local_correlation_softmax_stereo(rng, radius):
    b, h, w, c = 1, 4, 32, 32
    f0 = _normal(rng, b, h, w, c, scale=8)
    f1 = np.roll(f0, shift=-2, axis=2)
    disp, prob = tx.local_correlation_softmax_stereo(_t(f0), _t(f1), radius)
    jdisp, jprob = jx.local_correlation_softmax_stereo(jnp.asarray(f0), jnp.asarray(f1),
                                                       radius)
    _close(prob, jprob)
    _close(disp, jdisp, LOOSE)
    if radius == 4:
        np.testing.assert_allclose(disp.numpy()[:, :, 6:-4], 2, atol=0.2)


# -- the transformer's attn_type routing ----------------------------------------


@pytest.fixture(scope="module")
def transformer():
    """A two-layer transformer (d_model 128) on the port's seeded weights
    and JAX's tree of them (tools/convert_gmflow.py)."""
    port = tg.GMFlow(num_transformer_layers=2, num_reg_refine=1).eval()
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd, strict=True)
    params = convert_state_dict({k: v.numpy() for k, v in sd.items()}, num_layers=2)
    return port.transformer, params["core"]["transformer"]


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("attn_type", ATTN_TYPES)
def test_transformer_attn_types(rng, transformer, attn_type, splits):
    port, params = transformer
    f0, f1 = (_normal(rng, 1, 8, 16, 128) for _ in range(2))
    with torch.no_grad():
        got = port(_t(f0), _t(f1), splits, attn_type)
    want = jg.FeatureTransformer(num_layers=2).apply(
        {"params": params}, jnp.asarray(f0), jnp.asarray(f1), splits, attn_type)
    for g, w in zip(got, want):
        _close(g, w, LOOSE)


def test_stereo_routes_differ_from_swin(rng, transformer):
    """The routes compute different attention (the routing engages)."""
    port, _ = transformer
    f0, f1 = (_t(_normal(rng, 1, 8, 16, 128)) for _ in range(2))
    with torch.no_grad():
        outs = [port(f0, f1, 2, t)[0] for t in ATTN_TYPES]
    assert not torch.equal(outs[0], outs[1]) and not torch.equal(outs[1], outs[2])


def test_transformer_unknown_attn_type(rng, transformer):
    port, params = transformer
    f0 = _normal(rng, 1, 8, 16, 128)
    with pytest.raises(ValueError, match="unknown attn_type 'bogus'"):
        jg.FeatureTransformer(num_layers=2).apply({"params": params}, jnp.asarray(f0),
                                                  jnp.asarray(f0), 2, "bogus")
    with pytest.raises(ValueError, match="unknown attn_type 'bogus'"):
        port(_t(f0), _t(f0), 2, "bogus")


def test_stereo_routes_run_unfused(rng, transformer, monkeypatch):
    """The token-major routes never reach the fused window ops, even with
    ``fused_attention=True``."""
    port, _ = transformer
    fused = tg.FeatureTransformer(2, fused_attention=True)
    fused.load_state_dict(port.state_dict())

    def refuse(*args, **kwargs):
        raise AssertionError("a fused op ran")

    for name in ("window_sublayer_fused", "window_attention_fused", "ffn_fused"):
        monkeypatch.setattr(tg, name, refuse)
    f0 = _t(_normal(rng, 1, 8, 16, 128))
    with torch.no_grad():
        want = port(f0, f0, 2, "self_swin2d_cross_1d")
        got = fused(f0, f0, 2, "self_swin2d_cross_1d")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- depth/pose geometry -----------------------------------------------------------


def test_back_project_reproject(rng):
    h, w = 8, 16
    depth = rng.uniform(1.0, 5.0, (1, h, w)).astype(np.float32)
    k = _intrinsics()
    pts = tx.back_project(_t(depth), _t(k))
    _close(pts, jx.back_project(jnp.asarray(depth), jnp.asarray(k)))
    coords, mask = tx.reproject(pts, _t(k), return_mask=True)
    jcoords, jmask = jx.reproject(jx.back_project(jnp.asarray(depth), jnp.asarray(k)),
                                  jnp.asarray(k), return_mask=True)
    _close(coords, jcoords)
    np.testing.assert_array_equal(mask[:, 1:-1, 1:-1].numpy(), np.asarray(jmask)[:, 1:-1, 1:-1])
    np.testing.assert_allclose(coords[0].numpy(), tx.coords_grid(h, w).numpy(), atol=1e-3)


def test_identity_pose_gives_zero_rigid_flow(rng):
    h, w = 6, 10
    depth = rng.uniform(1.0, 5.0, (1, h, w)).astype(np.float32)
    k, eye = _intrinsics(), np.eye(4, dtype=np.float32)[None]
    flow, mask = tx.compute_flow_with_depth_pose(_t(depth), _t(k), extrinsics_ref=_t(eye),
                                                 extrinsics_tgt=_t(eye), return_mask=True)
    jflow, jmask = jx.compute_flow_with_depth_pose(
        jnp.asarray(depth), jnp.asarray(k), extrinsics_ref=jnp.asarray(eye),
        extrinsics_tgt=jnp.asarray(eye), return_mask=True)
    _close(flow, jflow)
    np.testing.assert_allclose(flow.numpy(), 0.0, atol=1e-3)
    # Boundary pixels sit on the mask's threshold, where rounding may flip them.
    assert mask[:, 1:-1, 1:-1].all() and np.asarray(jmask)[:, 1:-1, 1:-1].all()


def test_translation_pose_flow_is_parallax():
    h, w, d_const, tx_ = 6, 10, 2.0, 0.5
    depth = np.full((1, h, w), d_const, np.float32)
    k = _intrinsics(fx=20.0)
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = tx_
    flow = tx.compute_flow_with_depth_pose(_t(depth), _t(k), extrinsics_rel=_t(rel[None]))
    jflow = jx.compute_flow_with_depth_pose(jnp.asarray(depth), jnp.asarray(k),
                                            extrinsics_rel=jnp.asarray(rel[None]))
    _close(flow, jflow)
    np.testing.assert_allclose(flow[..., 0].numpy(), 20.0 * tx_ / d_const, rtol=1e-4)


def test_camera_transform(rng):
    pts = _normal(rng, 1, 4, 5, 3)
    c, s = np.cos(0.3), np.sin(0.3)
    ref = np.array([[[c, -s, 0, 0.2], [s, c, 0, -0.1], [0, 0, 1, 0.4], [0, 0, 0, 1]]],
                   dtype=np.float32)
    tgt = np.eye(4, dtype=np.float32)[None]
    got = tx.camera_transform(_t(pts), extrinsics_ref=_t(ref), extrinsics_tgt=_t(tgt))
    _close(got, jx.camera_transform(jnp.asarray(pts), extrinsics_ref=jnp.asarray(ref),
                                    extrinsics_tgt=jnp.asarray(tgt)))
    rel = tx.camera_transform(_t(pts), extrinsics_rel=_t(tgt @ np.linalg.inv(ref)))
    _close(rel, got.numpy())


# -- plane-sweep depth matching ----------------------------------------------------


def _depth_setup(rng, b=1, h=6, w=10, c=8):
    f1 = _normal(rng, b, h, w, c)
    k = np.asarray([[[12.0, 0, (w - 1) / 2], [0, 12.0, (h - 1) / 2], [0, 0, 1.0]]],
                   dtype=np.float32)
    return f1, k


@pytest.mark.parametrize("pose_kind", ["identity", "translation"])
def test_warp_with_pose_depth_candidates(rng, pose_kind):
    f1, k = _depth_setup(rng)
    b, h, w, c = f1.shape
    pose = np.eye(4, dtype=np.float32)[None]
    if pose_kind == "translation":
        pose[0, 0, 3] = 0.3
    depth = rng.uniform(1.0, 4.0, (b, 3, h, w)).astype(np.float32)
    got = tx.warp_with_pose_depth_candidates(_t(f1), _t(k), _t(pose), _t(depth))
    want = jx.warp_with_pose_depth_candidates(jnp.asarray(f1), jnp.asarray(k),
                                              jnp.asarray(pose), jnp.asarray(depth))
    assert got.shape == (b, 3, h, w, c)
    _close(got, want, LOOSE)
    if pose_kind == "identity":
        for di in range(3):
            np.testing.assert_allclose(got[:, di].numpy(), f1, atol=1e-4)


@pytest.mark.parametrize("argmax", [False, True])
def test_correlation_softmax_depth(rng, argmax):
    f1, k = _depth_setup(rng)
    b, h, w, c = f1.shape
    f0 = _normal(rng, b, h, w, c)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 0, 3] = 0.2
    cands = np.stack([np.full((h, w), 1.0 / z, np.float32) for z in (1.0, 2.0, 4.0)])[None]
    depth, prob = tx.correlation_softmax_depth(_t(f0), _t(f1), _t(k), _t(pose), _t(cands),
                                               depth_from_argmax=argmax)
    jdepth, jprob = jx.correlation_softmax_depth(jnp.asarray(f0), jnp.asarray(f1),
                                                 jnp.asarray(k), jnp.asarray(pose),
                                                 jnp.asarray(cands), depth_from_argmax=argmax)
    _close(prob, jprob)
    if argmax:
        np.testing.assert_array_equal(depth.numpy(), np.asarray(jdepth))
    else:
        _close(depth, jdepth, LOOSE)


def test_correlation_softmax_depth_uniform_when_pose_identity(rng):
    f1, k = _depth_setup(rng)
    b, h, w, c = f1.shape
    f0 = _normal(rng, b, h, w, c)
    pose = np.eye(4, dtype=np.float32)[None]
    cands = np.stack([np.full((h, w), 1.0 / z, np.float32) for z in (1.0, 2.0, 4.0)])[None]
    depth, prob = tx.correlation_softmax_depth(_t(f0), _t(f1), _t(k), _t(pose), _t(cands))
    np.testing.assert_allclose(prob.numpy(), 1.0 / 3, atol=1e-5)
    np.testing.assert_allclose(depth[:, 0].numpy(), np.mean([1.0, 0.5, 0.25]), rtol=1e-5)


def test_bidir_depth(rng):
    f1, k = _depth_setup(rng)
    b, h, w, c = f1.shape
    f0 = _normal(rng, b, h, w, c)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, 0, 3] = 0.2
    cands = np.full((b, 2, h, w), 0.5, np.float32)
    depth, prob = tx.correlation_softmax_depth(_t(f0), _t(f1), _t(k), _t(pose), _t(cands),
                                               pred_bidir_depth=True)
    jdepth, jprob = jx.correlation_softmax_depth(jnp.asarray(f0), jnp.asarray(f1),
                                                 jnp.asarray(k), jnp.asarray(pose),
                                                 jnp.asarray(cands), pred_bidir_depth=True)
    assert depth.shape == (2 * b, 1, h, w) and prob.shape == (2 * b, 2, h, w)
    _close(prob, jprob)
    _close(depth, jdepth, LOOSE)
    backward, _ = tx.correlation_softmax_depth(_t(f1), _t(f0), _t(k),
                                               torch.linalg.inv(_t(pose)), _t(cands))
    np.testing.assert_allclose(depth[b:].numpy(), backward.numpy(), rtol=1e-5, atol=1e-6)
