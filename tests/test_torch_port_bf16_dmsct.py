"""Port parity of DMSCT's bf16 recipes (color_transfer_tpu_torch/models/
dmsct.py, efficientnet.py, unet_decoder.py with the four precision knobs)
against color_transfer_tpu, per recipe of the JAX gate (examples/
deep_gate.py): ``bf16``, ``bf16m``, ``bf16c``, ``bf16+fused``,
``bf16-nofuse``, ``bf16+refine32``.

Stages, with JAX's intermediate fed in (one set of weights: the JAX tree
filled from a seeded generator, carried to the port by
``dmsct_state_dict_from_jax``): the encoder's levels, the decoder and head,
and the corrected image given the matcher's flow and occlusion
(``DMSCT.correct``). The matcher's own stages are held recipe by recipe in
test_torch_port_bf16_gmflow.py; here each recipe's model is checked to
carry JAX's knobs. Lines, in bf16 ulps of the output's magnitude (torch's
and XLA's CPU bf16 convs sum in other orders, so a value near a rounding
boundary flips by an ulp and feeds the next conv): the encoder's levels
within ENCODER_ULPS (measured: 2), the decoder and head within DECODER_ULPS
(measured: 1); the image given the flow within IMAGE_ATOL (the head's bf16
residual rounded, ulps of a residual of up to ~0.4, then added in f32).

End to end the bf16 matcher is chaotic at random init (a flip of one bf16
feature moves the flow, and the GRU loop amplifies it), so it is held by
rule C3 (ROADMAP.md): both packages run f32 and the recipe on the same
weights and distorted targets, and the port's recipe-against-f32 drift is
compared with JAX's, distortion by distortion, through the gate's
arithmetic (tools/deep_gate.py's deltas, the port's metrics on both). As a
script it prints every recipe over the whole grid:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_bf16_dmsct.py \\
        --height 64 --width 96
"""

import argparse
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.core.resize import resize_nearest, upsample_flow_bilinear
from color_transfer_tpu.core.sampling import flow_warp_batched
from color_transfer_tpu.models.dmsct import DMSCT as JDMSCT
from color_transfer_tpu.models.efficientnet import EfficientNetEncoder as JEncoder
from color_transfer_tpu.models.unet_decoder import (
    SegmentationHead as JHead,
    UnetDecoder as JDecoder,
)
from color_transfer_tpu_torch import metrics
from color_transfer_tpu_torch.data.distortions import setup_grid_distortions
from color_transfer_tpu_torch.models.dmsct import DMSCT
from color_transfer_tpu_torch.tools.convert import dmsct_state_dict_from_jax
from color_transfer_tpu_torch.tools.deep_gate import load_pair, recipe_kwargs

RECIPES = ["bf16", "bf16m", "bf16c", "bf16+fused", "bf16-nofuse", "bf16+refine32"]
KW = dict(matcher_num_layers=2, matcher_num_reg_refine=2)
H, W = 64, 96
ENCODER_ULPS, DECODER_ULPS, IMAGE_ATOL = 4, 2, 4e-3
# C3 at 64x96: the corrector-only recipe's deltas agree between the packages
# (measured: dPSNR within 0.0045 dB, dSSIM 8.3e-5, diCID 2.2e-4); a matcher
# recipe's output is as far from the other package's as from its own f32
# (measured: port against JAX bf16 40.8-46.5 dB where each package's drift
# from its f32 is 40.8-46.5 dB).
C3_D_PSNR, C3_D_SSIM, C3_D_ICID, C3_PAIR_PSNR = 0.01, 2e-4, 5e-4, 55.0
C3_MARGIN_DB = 3.0
INDICES = (0, 19, 28)


def _fill(path, shape, rng):
    name = path[-1].key
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    if name in ("bias", "mean"):
        return (0.05 * rng.normal(size=shape)).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)


def shared_variables(seed=11):
    """(JAX variables, port state_dict) holding the same numbers."""
    model = JDMSCT(**KW)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "dropout": jax.random.PRNGKey(1)}, x, x)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s.shape, rng),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    return v, dmsct_state_dict_from_jax(v["params"], v["batch_stats"])


def jax_kwargs(recipe):
    """The recipe's keywords for the JAX model on a CPU: its fused route in
    interpret mode (there "auto" and True would run unfused)."""
    kw = recipe_kwargs("dmsct", recipe) if recipe else {}
    fused = kw.get("matcher_fused_attention", "auto")
    if fused is True or (fused == "auto" and kw.get("matcher_compute_dtype")):
        kw["matcher_fused_attention"] = "interpret"
    return kw


def port_model(recipe, sd):
    m = DMSCT(**KW, **(recipe_kwargs("dmsct", recipe) if recipe else {})).eval()
    m.load_state_dict(sd, strict=True)
    return m


def _dtype(recipe):
    return jnp.bfloat16 if recipe_kwargs("dmsct", recipe).get("corrector_compute_dtype") else None


def _ulps(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.fixture(scope="module")
def shared():
    return shared_variables()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(3)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_builds_the_jax_model(shared, recipe):
    """The port's model of each recipe carries the JAX model's knobs: the
    matcher's dtypes and route, the corrector's dtype."""
    j = JDMSCT(**KW, **recipe_kwargs("dmsct", recipe))
    p = port_model(recipe, shared[1])

    def same(torch_dtype, jax_name):
        if jax_name is None:
            return torch_dtype is None
        return torch_dtype == getattr(torch, jnp.dtype(jax_name).name)

    assert same(p.matcher.corr_dtype, j.matcher_corr_dtype)
    assert same(p.matcher.compute_dtype, j.matcher_compute_dtype)
    assert same(p.matcher.refine_dtype, j.matcher_refine_dtype)
    assert same(p.encoder.dtype, j.corrector_compute_dtype)
    assert same(p.head.dtype, j.corrector_compute_dtype)
    layer = p.matcher.transformer.layers[0].cross_attn_ffn
    assert layer.fused_attention == j.matcher_fused_attention


@pytest.mark.parametrize("recipe", RECIPES)
def test_encoder_levels(shared, rng, recipe):
    v, sd = shared
    x = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    dt = _dtype(recipe)
    want = JEncoder(depth=4, dtype=dt).apply(
        {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]},
        jnp.asarray(x))
    with torch.no_grad():
        got = port_model(recipe, sd).encoder(torch.from_numpy(x))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == (torch.bfloat16 if dt else torch.float32)
        assert _ulps(g, w) <= (ENCODER_ULPS if dt else 1e-4 * 2**7)


@pytest.mark.parametrize("recipe", RECIPES)
def test_decoder_and_head(shared, rng, recipe):
    v, sd = shared
    chans = [7, 65, 49, 97, 241]  # 2C+1 per level for b2 / depth 4
    feats = [rng.normal(size=(1, 32 >> i, 48 >> i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    dt = _dtype(recipe)
    p = v["params"]
    want = JHead(3, dtype=dt).apply({"params": p["head"]}, JDecoder(
        (256, 128, 64, 32), dtype=dt).apply({"params": p["decoder"]}, *map(jnp.asarray, feats)))
    m = port_model(recipe, sd)
    with torch.no_grad():
        got = m.head(m.decoder(*map(torch.from_numpy, feats)))
    assert _ulps(got, want) <= (DECODER_ULPS if dt else 1e-4 * 2**7)


def _jax_correct(m, target, reference, flow, fwd_occ):
    """The corrector part of color_transfer_tpu's DMSCT.__call__ (after the
    matcher), as a method of the bound model."""
    _, height, width, _ = target.shape
    factor = 2**m.encoder_depth
    pad_h, pad_w = (-height) % factor, (-width) % factor

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)), mode="edge")

    flow = pad(flow)
    not_occ = pad(1.0 - fwd_occ)
    features = []
    for idx, (ft, fr) in enumerate(zip(m.encoder(pad(target)), m.encoder(pad(reference)))):
        ft, fr = ft.astype(jnp.float32), fr.astype(jnp.float32)
        flow_idx = upsample_flow_bilinear(flow, 2.0**-idx) if idx else flow
        warped = flow_warp_batched(fr, flow_idx)
        occ = (jnp.moveaxis(resize_nearest(jnp.moveaxis(not_occ, -1, 1), flow_idx.shape[1:3]),
                            1, -1) if idx else not_occ)
        features.append(jnp.concatenate([ft, warped, occ], axis=-1))
    residual = m.head(m.decoder(*features)).astype(jnp.float32)
    return jnp.clip(target + residual[:, :height, :width, :], 0.0, 1.0)


@pytest.mark.parametrize("recipe", RECIPES)
def test_image_given_the_flow(shared, rng, recipe):
    """The corrected image from the same target, reference, flow and
    occlusion (H, W not multiples of 16: the edge pad), f32 out."""
    v, sd = shared
    h, w = 30, 50
    t = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    r = np.clip(np.roll(t, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    flow = (rng.normal(size=(1, h, w, 2)) * 2.5).astype(np.float32)
    occ = (rng.uniform(size=(1, h, w, 1)) < 0.1).astype(np.float32)
    model = JDMSCT(**KW, **jax_kwargs(recipe))
    want = model.apply(v, *map(jnp.asarray, (t, r, flow, occ)), method=_jax_correct)
    with torch.no_grad():
        got = port_model(recipe, sd).correct(*map(torch.from_numpy, (t, r, flow, occ)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IMAGE_ATOL, rtol=0)


# -- C3: whose is the drift ------------------------------------------------------


def _forwards(recipe, v, sd):
    """(JAX forward, port forward) of ``recipe`` ("" = f32): (1, H, W, 3)
    numpy in and out, clipped."""
    jm = JDMSCT(**KW, **jax_kwargs(recipe))
    jf = jax.jit(lambda t, r: jm.apply(v, t, r))
    pm = port_model(recipe, sd)

    def pf(t, r):
        with torch.no_grad():
            return pm(torch.from_numpy(t), torch.from_numpy(r)).clamp(0, 1).float().numpy()
    return (lambda t, r: np.array(jnp.clip(jf(jnp.asarray(t), jnp.asarray(r)), 0, 1),
                                  np.float32), pf)


def _psnr(a, b):
    return float(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)))


def compare(recipes, height=H, width=W, indices=INDICES, seed=11):
    """{recipe: rows}: per distortion each package's gate deltas (recipe
    against f32: dPSNR, dSSIM, diCID against the clean plate), each
    package's pair PSNR recipe against its f32, and port against JAX in the
    recipe."""
    v, sd = shared_variables(seed)
    gt, ref = load_pair(height, width)
    g4, r4 = gt[None].copy(), np.ascontiguousarray(ref[None])
    grid = setup_grid_distortions()
    indices = range(len(grid)) if indices is None else indices
    base = _forwards("", v, sd)
    targets = {i: grid[i](torch.from_numpy(gt)).clamp(0, 1)[None].numpy() for i in indices}
    f32 = {i: [fn(targets[i], r4) for fn in base] for i in indices}

    def quality(o):
        o, g = torch.from_numpy(o), torch.from_numpy(g4)
        return float(metrics.psnr(o, g)), float(metrics.ssim(o, g)), float(metrics.icid(o, g))

    out = {}
    for recipe in recipes:
        fns = _forwards(recipe, v, sd)
        rows = []
        for i in indices:
            rec = [fn(targets[i], r4) for fn in fns]
            row = {"i": i}
            for k, pkg in enumerate(("jax", "port")):
                for m, a, b in zip(("psnr", "ssim", "icid"), quality(rec[k]), quality(f32[i][k])):
                    row[f"{pkg}_d_{m}"] = a - b
                row[f"{pkg}_drift_psnr"] = _psnr(rec[k], f32[i][k])
            row["port_vs_jax_psnr"] = _psnr(rec[1], rec[0])
            row["f32_port_vs_jax_max"] = float(np.abs(f32[i][1] - f32[i][0]).max())
            rows.append(row)
        out[recipe] = rows
    return out


@pytest.fixture(scope="module")
def c3_rows():
    return compare(["bf16c", "bf16"])


def test_c3_corrector_recipe_drift_is_jaxs(c3_rows):
    """bf16c (the matcher f32, no chaos): the port's gate deltas are JAX's,
    distortion by distortion, and the two bf16 outputs agree closely."""
    for row in c3_rows["bf16c"]:
        assert row["f32_port_vs_jax_max"] < 1e-4, row
        assert abs(row["port_d_psnr"] - row["jax_d_psnr"]) < C3_D_PSNR, row
        assert abs(row["port_d_ssim"] - row["jax_d_ssim"]) < C3_D_SSIM, row
        assert abs(row["port_d_icid"] - row["jax_d_icid"]) < C3_D_ICID, row
        assert row["port_vs_jax_psnr"] > C3_PAIR_PSNR, row


def test_c3_matcher_recipe_drift_is_the_recipes(c3_rows):
    """bf16 (the matcher in bf16, chaotic at random init): the port's bf16
    output is no farther from JAX's bf16 output than either package's
    drifts from its own f32, and the two packages drift alike."""
    for row in c3_rows["bf16"]:
        assert row["f32_port_vs_jax_max"] < 1e-4, row
        own = min(row["jax_drift_psnr"], row["port_drift_psnr"])
        assert row["port_vs_jax_psnr"] > own - C3_MARGIN_DB, row
        assert abs(row["jax_drift_psnr"] - row["port_drift_psnr"]) < C3_MARGIN_DB, row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--limit", type=int, default=0, help="first N distortions (0: all)")
    ap.add_argument("--recipes", default=",".join(RECIPES))
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    out = compare(args.recipes.split(","), args.height, args.width,
                  range(args.limit) if args.limit else None)
    for recipe, rows in out.items():
        for row in rows:
            print(json.dumps({"recipe": recipe, **{k: (round(x, 7) if isinstance(x, float)
                                                       else x) for k, x in row.items()}}))


if __name__ == "__main__":
    main()
else:
    from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
