"""Port parity: the GMFlow matcher (color_transfer_tpu_torch/models/gmflow.py)
against color_transfer_tpu/models/gmflow.py, stage by stage and end to end.

One set of weights: the port's seeded random state_dict, mapped onto the JAX
tree by the JAX package's own converter (tools/convert_gmflow.py), which
reads the reference torch layout the port keeps. Reduced depth (2
transformer layers, 2 refinements), full widths, 64x96 images.

Stage tests feed each port stage the JAX intermediate that the JAX forward
produced at that point (captured from the bound JAX modules), so an error
is charged to the stage that makes it. Lines:
  * stages: max|d| <= 1e-4 * max(1, max|ref|) — float32 on both sides,
    sums in another order;
  * end-to-end flow: max|d| < max(2e-3, 1e-3 * max|flow|), the line of
    tests/test_torch_parity.py (the GRU refinement amplifies rounding);
  * occlusion masks are thresholded, so a flip right at the threshold is
    possible: at most 2% of pixels may disagree, as in test_torch_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import gmflow as jg
from color_transfer_tpu.tools.convert_gmflow import convert_state_dict
from color_transfer_tpu_torch.models import gmflow as tg
from color_transfer_tpu_torch.run.modules import random_state_dict
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

LAYERS, REFINE = 2, 2
STAGE_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, rtol=STAGE_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def _flow_line(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err < max(2e-3, 1e-3 * scale), (err, scale)


@pytest.fixture(scope="module")
def models():
    port = tg.GMFlow(num_transformer_layers=LAYERS, num_reg_refine=REFINE).eval()
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd, strict=True)
    params = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                num_layers=LAYERS)
    return port, params


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    img0 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img1 = (np.roll(img0, 3, axis=2) * 0.9
            + rng.uniform(0, 20, img0.shape)).astype(np.float32)
    return img0, img1


@pytest.fixture(scope="module")
def jax_stages(models, images):
    """The JAX bidirectional forward, step by step, with every stage's
    inputs and outputs recorded (numpy)."""
    _, params = models
    core = jg.UniMatchFlow(num_transformer_layers=LAYERS).bind(
        {"params": params["core"]}
    )
    s = {}
    mean, std = jg._IMAGENET_MEAN, jg._IMAGENET_STD
    img0 = (jnp.asarray(images[0]) / 255.0 - mean) / std
    img1 = (jnp.asarray(images[1]) / 255.0 - mean) / std
    s["backbone_in"] = jnp.concatenate([img0, img1], axis=0)
    s["backbone_out"] = core.backbone(s["backbone_in"])
    f0_list, f1_list = core.extract_feature(img0, img1)

    # Scale 0 (1/8): global matching + global propagation, bidirectional.
    f0, f1 = jg.feature_add_position(f0_list[0], f1_list[0], 2, 128)
    s["tf0_in"] = (f0, f1)
    f0, f1 = core.transformer(f0, f1, 2)
    s["tf0_out"] = (f0, f1)
    s["global_flow"], s["global_prob"] = jg.global_correlation_softmax(f0, f1, True)
    s["prop0_in"] = (jnp.concatenate([f0, f1], axis=0), s["global_flow"])
    s["prop0_out"] = core.feature_flow_attn(*s["prop0_in"])

    # Scale 1 (1/4): warp, local matching + local propagation, refinement.
    f0 = jnp.concatenate([f0_list[1], f1_list[1]], axis=0)
    f1 = jnp.concatenate([f1_list[1], f0_list[1]], axis=0)
    f0_ori, f1_ori = f0, f1
    up = jg.resize_bilinear(jnp.moveaxis(s["prop0_out"], -1, 1), f0.shape[1:3],
                            align_corners=True)
    flow = jnp.moveaxis(up, 1, -1) * 2.0
    f1 = jax.vmap(jg.flow_warp)(f1, flow)
    f0, f1 = jg.feature_add_position(f0, f1, 8, 128)
    s["tf1_in"] = (f0, f1)
    f0, f1 = core.transformer(f0, f1, 8)
    s["tf1_out"] = (f0, f1)
    s["local_flow"], s["local_prob"] = jg.local_correlation_softmax(f0, f1, 4)
    flow = flow + s["local_flow"]
    s["prop1_in"] = (f0, flow)
    flow = core.feature_flow_attn(f0, flow, local_window_attn=True,
                                  local_window_radius=1)
    s["prop1_out"] = flow
    corr = jg.local_correlation_with_flow(f0_ori, f1_ori, flow, 4, impl="xla")
    proj = core.refine_proj(f0)
    net, inp = jnp.split(proj, 2, axis=-1)
    s["refine_in"] = (jnp.tanh(net), jax.nn.relu(inp), corr, flow)
    s["refine_out"] = core.refine(*s["refine_in"])
    return jax.tree_util.tree_map(np.asarray, s)


def test_cnn_encoder(models, jax_stages):
    port, _ = models
    with torch.no_grad():
        got = port.backbone(_t(jax_stages["backbone_in"]))
    for g, w in zip(got, jax_stages["backbone_out"]):
        _close(g, w)


@pytest.mark.parametrize("scale", [0, 1])
def test_feature_transformer(models, jax_stages, scale):
    """Both scales: attn_splits 2 (8x12 features) and 8 (16x24), each with an
    unshifted and a shifted layer."""
    port, _ = models
    splits = (2, 8)[scale]
    with torch.no_grad():
        got = port.transformer(*map(_t, jax_stages[f"tf{scale}_in"]), splits)
    for g, w in zip(got, jax_stages[f"tf{scale}_out"]):
        _close(g, w)


@pytest.mark.parametrize("shift", [False, True])
def test_transformer_block(models, rng, shift):
    """One TransformerBlock on window-major tokens, with and without the
    shifted-window mask (k = 2 windows of 4x6 over an 8x12 image)."""
    port, params = models
    k, h, w, c = 2, 8, 12, 128
    hs, ws = h // k, w // k
    src = rng.normal(size=(2 * k * k, hs * ws, c)).astype(np.float32)
    tgt = np.concatenate(np.split(src, 2)[::-1])
    mask = jg._shift_window_mask(h, w, k) if shift else None
    want = jg.TransformerBlock(c).apply(
        {"params": params["core"]["transformer"]["layer_1"]},
        jnp.asarray(src), jnp.asarray(tgt), hs, ws, with_shift=shift,
        attn_num_splits=k, windowed=True,
        win_mask=None if mask is None else jnp.asarray(mask),
    )
    with torch.no_grad():
        got = port.transformer.layers[1](_t(src), _t(tgt),
                                         None if mask is None else _t(mask))
    _close(got, want)


def test_global_correlation_softmax_bidir(jax_stages):
    flow, prob = tg.global_correlation_softmax(*map(_t, jax_stages["tf0_out"]), True)
    assert flow.shape[0] == 2  # [fwd x B, bwd x B]
    _close(flow, jax_stages["global_flow"])
    _close(prob, jax_stages["global_prob"])


def test_local_correlation_softmax(jax_stages):
    flow, prob = tg.local_correlation_softmax(*map(_t, jax_stages["tf1_out"]), 4)
    _close(flow, jax_stages["local_flow"])
    _close(prob, jax_stages["local_prob"])


@pytest.mark.parametrize("scale", [0, 1])
def test_self_attn_propagation(models, jax_stages, scale):
    """Global propagation at 1/8, local 3x3 (radius 1) at 1/4."""
    port, _ = models
    feat, flow = map(_t, jax_stages[f"prop{scale}_in"])
    with torch.no_grad():
        got = port.feature_flow_attn(feat, flow, local_window_attn=scale == 1,
                                     local_window_radius=1)
    _close(got, jax_stages[f"prop{scale}_out"])


def test_update_block_step(models, jax_stages):
    port, _ = models
    with torch.no_grad():
        got = port.refine(*map(_t, jax_stages["refine_in"]))
    for g, w in zip(got, jax_stages["refine_out"]):
        _close(g, w)


def test_upsample_flow_with_mask(rng):
    flow = (rng.normal(size=(2, 5, 7, 2)) * 3).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 144)).astype(np.float32)
    want = jg.upsample_flow_with_mask(jnp.asarray(flow), jnp.asarray(mask), 4)
    _close(tg.upsample_flow_with_mask(_t(flow), _t(mask), 4), want)


@pytest.mark.parametrize("portrait", [False, True])
def test_gmflow_end_to_end(models, images, portrait):
    """The wrapper protocol: x32 resize, bidirectional flow, fwd/bwd
    occlusion; the portrait case runs transposed through the matcher."""
    port, params = models
    img0, img1 = images
    if portrait:
        # 64x56: H > W, and the transposed 56x64 takes the x32 resize path.
        img0, img1 = (np.ascontiguousarray(i[:, :, :56]) for i in images)
    want = jax.jit(jg.GMFlow(num_transformer_layers=LAYERS,
                             num_reg_refine=REFINE).apply)(
        {"params": params}, jnp.asarray(img0), jnp.asarray(img1)
    )
    with torch.no_grad():
        got = port(_t(img0), _t(img1))
    assert set(got) == set(want) == {"flow", "flow_bwd", "fwd_occ", "bwd_occ"}
    for key in ("flow", "flow_bwd"):
        assert got[key].shape == want[key].shape
        _flow_line(got[key].numpy(), want[key])
    for key in ("fwd_occ", "bwd_occ"):
        assert got[key].shape == want[key].shape
        assert float(np.mean(got[key].numpy() != np.asarray(want[key]))) < 0.02


@pytest.mark.parametrize("h,w,k", [(8, 12, 2), (16, 24, 8), (8, 16, 8), (64, 112, 2)])
def test_shift_window_mask(h, w, k):
    """Includes one-row windows (8x16 at k = 8), where the bands overlap."""
    np.testing.assert_array_equal(tg.shift_window_mask(h, w, k).numpy(),
                                  jg._shift_window_mask(h, w, k))


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_feature_add_position(rng, splits):
    f0 = rng.normal(size=(2, 16, 24, 128)).astype(np.float32)
    f1 = rng.normal(size=(2, 16, 24, 128)).astype(np.float32)
    want = jg.feature_add_position(jnp.asarray(f0), jnp.asarray(f1), splits, 128)
    got = tg.feature_add_position(_t(f0), _t(f1), splits, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# -- the fused transformer route (fused_attention=True) -------------------------


@pytest.fixture(scope="module")
def fused_port(models):
    port, _ = models
    fused = tg.GMFlow(num_transformer_layers=LAYERS, num_reg_refine=REFINE,
                      fused_attention=True).eval()
    fused.load_state_dict(port.state_dict(), strict=True)
    return fused


@pytest.mark.parametrize("scale", [0, 1])
def test_feature_transformer_fused(models, fused_port, jax_stages, monkeypatch, scale):
    """The fused route (B2b sublayers and B2c FFNs; their plain versions on
    the CPU) against JAX's FeatureTransformer with fused_attention=
    "interpret" (the Pallas kernels in interpret mode), on the same
    bridged weights and inputs, at both scales (windows of 4x6 at 2
    splits, 2x3 at 8)."""
    _, params = models
    splits = (2, 8)[scale]
    calls = {"sublayer": 0, "ffn": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(tg, "window_sublayer_fused",
                        counted("sublayer", tg.window_sublayer_fused))
    monkeypatch.setattr(tg, "ffn_fused", counted("ffn", tg.ffn_fused))
    f0, f1 = jax_stages[f"tf{scale}_in"]
    with torch.no_grad():
        got = fused_port.transformer(_t(f0), _t(f1), splits)
    want = jg.FeatureTransformer(num_layers=LAYERS, fused_attention="interpret").apply(
        {"params": params["core"]["transformer"]}, jnp.asarray(f0), jnp.asarray(f1), splits)
    for g, w in zip(got, want):
        _close(g, w)
    assert calls == {"sublayer": 2 * LAYERS, "ffn": LAYERS}


def test_fused_route_is_opt_in(models, jax_stages, monkeypatch):
    """"auto" (float32 tokens) and False take the unfused route: no fused
    op is called and the default path's output is unchanged."""
    port, _ = models
    monkeypatch.setattr(tg, "window_sublayer_fused", None)
    monkeypatch.setattr(tg, "ffn_fused", None)
    monkeypatch.setattr(tg, "window_attention_fused", None)
    assert port.transformer.layers[0].self_attn.fused_attention == "auto"
    f0, f1 = map(_t, jax_stages["tf1_in"])
    with torch.no_grad():
        got = port.transformer(f0, f1, 8)
        off = tg.FeatureTransformer(LAYERS, fused_attention=False)
        off.load_state_dict(port.transformer.state_dict())
        for g, w in zip(got, off(f0, f1, 8)):
            assert torch.equal(g, w)


def test_fused_attention_values_checked():
    with pytest.raises(ValueError, match="interpret"):
        tg.TransformerLayer(32, fused_attention="interpret")


def test_fused_route_needs_windows(jax_stages, monkeypatch):
    """As in JAX, one window per image (attn splits 1) is not windowed: the
    layers stay unfused even with fused_attention=True."""
    fused = tg.FeatureTransformer(LAYERS, fused_attention=True)
    monkeypatch.setattr(tg, "window_sublayer_fused", None)
    monkeypatch.setattr(tg, "ffn_fused", None)
    f0, f1 = jax_stages["tf0_in"]
    with torch.no_grad():
        got = fused(_t(f0), _t(f1), 1)
    assert got[0].shape == f0.shape
