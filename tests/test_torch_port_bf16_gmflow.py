"""Port parity of the matcher's bf16 recipes (color_transfer_tpu_torch/
models/gmflow.py with ``compute_dtype``, ``corr_dtype`` and
``refine_dtype``) against color_transfer_tpu/models/gmflow.py, stage by
stage, with JAX's intermediate fed in.

The GRU loop amplifies any rounding at random init (PARITY_RESULTS.md
round-5), so the bf16 matcher is not held to JAX's end to end by value: each
stage of the port runs on the inputs JAX's forward gave that stage and is
held to JAX's output of the stage. The recipes' matchers (the DMSCT recipe
names of examples/deep_gate.py): ``bf16`` (bf16m, bf16+fused: the backbone
and transformer in bf16, the transformer fused, B1 in bf16),
``bf16-nofuse`` (unfused), ``bf16+refine32`` (fused, the flow arithmetic
after the transformer in f32, B1 in f32). JAX runs its fused route as
``fused_attention="interpret"`` (the Pallas kernels in interpret mode; on a
CPU its "auto" would not fuse), the port its fused ops' plain versions.
One set of weights (the port's seeded state_dict through the JAX package's
converter), 2 transformer layers, 2 refinements, 64x96 images.

The lines:
  * a stage whose output is bf16, in bf16 ulps of the output's magnitude
    (an ulp of a bf16 value x is 2^(floor(log2|x|) - 7)): the two packages
    round the same values at the same points, but torch's and XLA's CPU
    bf16 convs and matmuls sum in other orders and the elementwise chains
    (GELU, the bias adds) round at other points, so a value near a rounding
    boundary flips by one ulp and the flip feeds the next op. A transformer
    layer within LAYER_ULPS (measured: at most 1); the backbone, 13 convs
    deep, within BACKBONE_ULPS (measured: 3);
  * a stage whose output is f32 (the correlation softmaxes, the
    propagation, B1, the refinement step): F32_LINE of max(1, max|ref|),
    the f32 stages' line of test_torch_port_gmflow.py (measured: at most
    1.5e-5; their inputs are JAX's, their products exact in f32);
  * a scale's flow given the previous one (warp, position, transformer,
    correlation and propagation in one): at most SCALE_FLOW_MAX pixels and
    SCALE_FLOW_MEAN on average (measured: 0.14 and 0.023, on flows of 5-10
    pixels): a feature that flips by an ulp inside the scale moves the
    correlation softmax's expected coordinate by a fraction of a pixel.
"""

import math

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
LAYER_ULPS, BACKBONE_ULPS = 4, 8
F32_LINE = 1e-4
SCALE_FLOW_MAX, SCALE_FLOW_MEAN = 0.5, 0.1
BF16 = torch.bfloat16
# recipe -> (corr, compute, refine, fused): the JAX package's DMSCT recipe
# keywords (examples/deep_gate.py::build_model) for the matcher.
MATCHERS = {
    "bf16": ("bfloat16", "bfloat16", None, "auto"),
    "bf16-nofuse": ("bfloat16", "bfloat16", None, False),
    "bf16+refine32": ("bfloat16", "bfloat16", "float32", "auto"),
}


def _t(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def ulps_of(got, want):
    """max|got - want| in bf16 ulps of max|want|."""
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _bf16_close(got, want, ulps):
    assert got.dtype == BF16 and jnp.asarray(want).dtype == jnp.bfloat16
    err = ulps_of(got, want)
    assert err <= ulps, err


def _f32_close(got, want, line=F32_LINE):
    g = got.detach().numpy()
    w = np.asarray(want)
    assert got.dtype == torch.float32 and g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= line * max(1.0, float(np.abs(w).max())), err


def _jdt(name):
    return None if name is None else jnp.dtype(name).type


@pytest.fixture(scope="module")
def weights():
    port = tg.GMFlow(num_transformer_layers=LAYERS, num_reg_refine=REFINE)
    sd = random_state_dict(port, seed=3)
    params = convert_state_dict({k: v.numpy() for k, v in sd.items()}, num_layers=LAYERS)
    return sd, params


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    img0 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img1 = (np.roll(img0, 3, axis=2) * 0.9 + rng.uniform(0, 20, img0.shape)).astype(np.float32)
    return img0, img1


def port_matcher(recipe, sd):
    corr, compute, refine, fused = MATCHERS[recipe]
    m = tg.GMFlow(LAYERS, REFINE, fused_attention=fused, corr_dtype=getattr(torch, corr),
                  compute_dtype=getattr(torch, compute),
                  refine_dtype=None if refine is None else getattr(torch, refine)).eval()
    m.load_state_dict(sd, strict=True)
    return m


def jax_core(recipe, params):
    corr, compute, refine, fused = MATCHERS[recipe]
    return jg.UniMatchFlow(
        num_transformer_layers=LAYERS, corr_dtype=_jdt(corr), compute_dtype=_jdt(compute),
        refine_dtype=_jdt(refine), fused_attention="interpret" if fused == "auto" else fused,
    ).bind({"params": params["core"]})


def _window_layers(core, f0, f1, splits):
    """JAX's window-major transformer loop, layer by layer: [(src, tgt,
    shifted, out)] in window-major tokens, and the scale's output."""
    dt = core.compute_dtype
    f0, f1 = f0.astype(dt), f1.astype(dt)
    b, h, w, c = f0.shape
    k = splits
    hs, ws = h // k, w // k

    def to_win(x):
        return jg.split_windows(x, k).reshape(-1, hs * ws, c)

    def from_win(x):
        return jg.merge_windows(x.reshape(-1, hs, ws, c), k)

    mask = jnp.asarray(jg._shift_window_mask(h, w, k))
    src = to_win(jnp.concatenate([f0, f1], axis=0))
    layers = []
    for i in range(LAYERS):
        shifted = i % 2 == 1
        if shifted:
            src = to_win(jnp.roll(from_win(src), (-(hs // 2), -(ws // 2)), axis=(1, 2)))
        tgt = jnp.concatenate(jnp.split(src, 2, axis=0)[::-1], axis=0)
        out = jg.TransformerBlock(c, dtype=dt, fused_attention=core.fused_attention).apply(
            {"params": core.variables["params"]["transformer"][f"layer_{i}"]},
            src, tgt, hs, ws, with_shift=shifted, attn_num_splits=k, windowed=True,
            win_mask=mask if shifted else None)
        layers.append((src, tgt, shifted, out))
        src = out
        if shifted:
            src = to_win(jnp.roll(from_win(src), (hs // 2, ws // 2), axis=(1, 2)))
    return layers, (k, hs, ws), np.asarray(mask)


_STAGES = {}


def jax_stages(recipe, params, images):
    """JAX's forward of the recipe, step by step, each stage's inputs and
    outputs recorded."""
    if recipe in _STAGES:
        return _STAGES[recipe]
    core = jax_core(recipe, params)
    s = {}
    mean, std = jg._IMAGENET_MEAN, jg._IMAGENET_STD
    img0 = (jnp.asarray(images[0]) / 255.0 - mean) / std
    img1 = (jnp.asarray(images[1]) / 255.0 - mean) / std
    s["backbone_in"] = jnp.concatenate([img0, img1], axis=0)
    s["backbone_out"] = core.backbone(s["backbone_in"])
    f0_list, f1_list = core.extract_feature(img0, img1)
    refine = core.refine_dtype

    flow = None
    for scale, splits in enumerate((2, 8)):
        f0, f1 = f0_list[scale], f1_list[scale]
        s[f"scale{scale}_in"] = (f0, f1, flow)
        if scale:
            f0, f1 = jnp.concatenate([f0, f1], 0), jnp.concatenate([f1, f0], 0)
        f0_ori, f1_ori = f0, f1
        if scale:
            up = jg.resize_bilinear(jnp.moveaxis(flow, -1, 1), f0.shape[1:3], align_corners=True)
            flow = jnp.moveaxis(up, 1, -1) * 2.0
            f1 = jax.vmap(jg.flow_warp)(f1, flow)
        f0, f1 = jg.feature_add_position(f0, f1, splits, 128)
        s[f"layers{scale}"] = _window_layers(core, f0, f1, splits)
        f0, f1 = core.transformer(f0, f1, splits)
        if refine is not None:
            f0, f1, f0_ori, f1_ori = (t.astype(refine) for t in (f0, f1, f0_ori, f1_ori))
        s[f"corr{scale}_in"] = (f0, f1)
        if scale == 0:
            s["corr0_out"] = jg.global_correlation_softmax(f0, f1, True)[0]
            f0 = jnp.concatenate([f0, f1], axis=0)
        else:
            s["corr1_out"] = jg.local_correlation_softmax(f0, f1, 4)[0]
        flow = flow + s[f"corr{scale}_out"] if scale else s["corr0_out"]
        s[f"prop{scale}_in"] = (f0, flow)
        flow = core.feature_flow_attn(f0, flow, local_window_attn=scale == 1,
                                      local_window_radius=1)
        s[f"prop{scale}_out"] = flow
        s[f"scale{scale}_out"] = (flow, f0, f0_ori, f1_ori)

    # One refinement iteration: B1 on the TPU kernel's route (interpret) in
    # its dtype, the projection and the update block.
    cd = jnp.dtype(refine if refine is not None else core.corr_dtype)
    args = (f0_ori, f1_ori, flow)
    if cd == jnp.bfloat16:
        corr = jg._local_corr_pallas_ad(4, cd, True, "mxu", *args)
    else:
        corr = jg.local_correlation_with_flow(*args, 4, corr_dtype=cd, impl="xla")
    s["b1_in"], s["b1_out"] = args, corr
    net, inp = jnp.split(core.refine_proj(f0), 2, axis=-1)
    s["refine_in"] = (jnp.tanh(net), jax.nn.relu(inp), corr, flow)
    s["refine_out"] = core.refine(*s["refine_in"])
    _STAGES[recipe] = s
    return s


RECIPES = list(MATCHERS)


@pytest.mark.parametrize("recipe", RECIPES)
def test_backbone(weights, images, recipe):
    s = jax_stages(recipe, weights[1], images)
    port = port_matcher(recipe, weights[0])
    with torch.no_grad():
        got = port.backbone(_t(s["backbone_in"]))
    for g, w in zip(got, s["backbone_out"]):
        _bf16_close(g, w, BACKBONE_ULPS)


@pytest.mark.parametrize("layer", range(LAYERS))
@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("recipe", RECIPES)
def test_transformer_layer(weights, images, recipe, scale, layer):
    """Each TransformerBlock on JAX's window-major input at both scales (the
    1/8 scale's windows are unfused in every recipe, as L fails no guard
    here but the fused route runs on both in the fused recipes)."""
    s = jax_stages(recipe, weights[1], images)
    port = port_matcher(recipe, weights[0])
    layers, geom, mask = s[f"layers{scale}"]
    src, tgt, shifted, want = layers[layer]
    with torch.no_grad():
        got = port.transformer.layers[layer](
            _t(src), _t(tgt), torch.from_numpy(mask) if shifted else None,
            shift_windows=geom if shifted else None, windowed=True)
    _bf16_close(got, want, LAYER_ULPS)


@pytest.mark.parametrize("recipe", RECIPES)
def test_correlation_softmaxes(weights, images, recipe):
    """The global (1/8) and local (1/4) correlation softmaxes on the
    features in the dtype JAX gives them (bf16, or f32 under refine32)."""
    s = jax_stages(recipe, weights[1], images)
    with torch.no_grad():
        _f32_close(tg.global_correlation_softmax(*map(_t, s["corr0_in"]), True)[0],
                   s["corr0_out"])
        _f32_close(tg.local_correlation_softmax(*map(_t, s["corr1_in"]), 4)[0],
                   s["corr1_out"])


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("recipe", RECIPES)
def test_self_attn_propagation(weights, images, recipe, scale):
    s = jax_stages(recipe, weights[1], images)
    port = port_matcher(recipe, weights[0])
    feat, flow = s[f"prop{scale}_in"]
    with torch.no_grad():
        got = port.feature_flow_attn(_t(feat), _t(flow), local_window_attn=scale == 1,
                                     local_window_radius=1)
    _f32_close(got, s[f"prop{scale}_out"])


@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("recipe", RECIPES)
def test_scale_flow(weights, images, recipe, scale):
    """A whole scale (``UniMatchFlow.scale_step``) given JAX's backbone
    features and previous flow: the flow, and the features it hands the
    GRU loop (exact: the backbone's, cast)."""
    s = jax_stages(recipe, weights[1], images)
    port = port_matcher(recipe, weights[0])
    f0, f1, prev = s[f"scale{scale}_in"]
    with torch.no_grad():
        flow, _, f0_ori, f1_ori = port.scale_step(scale, _t(f0), _t(f1),
                                                  None if prev is None else _t(prev))
    want_flow, _, want0, want1 = s[f"scale{scale}_out"]
    d = np.abs(flow.numpy() - np.asarray(want_flow))
    assert float(d.max()) <= SCALE_FLOW_MAX and float(d.mean()) <= SCALE_FLOW_MEAN
    for g, w in ((f0_ori, want0), (f1_ori, want1)):
        assert g.dtype == _t(w).dtype
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(jnp.asarray(w).astype(jnp.float32)))


@pytest.mark.parametrize("recipe", RECIPES)
def test_refine_iteration(weights, images, recipe):
    """One GRU iteration: B1 in the recipe's dtype (JAX's Pallas MXU route in
    interpret mode for bf16), refine_proj and the update block (f32)."""
    s = jax_stages(recipe, weights[1], images)
    port = port_matcher(recipe, weights[0])
    corr_dtype = port.refine_dtype if port.refine_dtype is not None else port.corr_dtype
    with torch.no_grad():
        corr = tg.local_correlation_with_flow(*map(_t, s["b1_in"]), 4, corr_dtype=corr_dtype)
        _f32_close(corr, s["b1_out"])
        got = port.refine(*map(_t, s["refine_in"]))
    for g, w in zip(got, s["refine_out"]):
        _f32_close(g, w)


def test_recipes_fuse_as_jax_routes(weights):
    """"auto" fuses exactly in bf16: the fused recipes' layers take the fused
    route, nofuse's do not (JAX's TransformerLayer rule)."""
    sd, _ = weights
    for recipe, want in (("bf16", True), ("bf16-nofuse", False)):
        m = port_matcher(recipe, sd)
        layer = m.transformer.layers[0].self_attn
        assert layer.dtype == torch.bfloat16
        assert (layer.fused_attention in ("auto", True)) == want
