"""Port parity: DMSCT (color_transfer_tpu_torch/models/dmsct.py, efficientnet,
unet_decoder) and the weight bridge (tools/convert.py) against
color_transfer_tpu.

The JAX variables are the JAX model's own tree (its structure from
``jax.eval_shape(model.init, ...)``), filled from a seeded numpy generator;
they reach the port through ``dmsct_state_dict_from_jax``. Reduced matcher
depth (1 transformer layer, 1 refinement), full widths elsewhere.

Lines:
  * encoder pyramid, decoder and head: max|d| <= 1e-4 * max(1, max|ref|)
    (float32 on both sides, sums in another order);
  * DMSCT end to end: corrected image atol 1e-3; the matcher's flow on the
    GMFlow line max(2e-3, 1e-3 * max|flow|) of tests/test_torch_parity.py.
The fused matcher route (``matcher_fused_attention=True``; the fused ops'
plain versions on the CPU) is held end to end, at 2 transformer layers and 2
refinements, to JAX's ``matcher_fused_attention="interpret"`` (its Pallas
kernels in interpret mode) on the same lines.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models.dmsct import DMSCT as JDMSCT
from color_transfer_tpu.models.efficientnet import EfficientNetEncoder as JEncoder
from color_transfer_tpu.models.unet_decoder import (
    SegmentationHead as JHead,
    UnetDecoder as JDecoder,
)
from color_transfer_tpu.tools.convert_checkpoints import convert_dmsct
from color_transfer_tpu_torch.core.resize import derive_matcher_size
from color_transfer_tpu_torch.models.dmsct import DMSCT
from color_transfer_tpu_torch.tools.convert import dmsct_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

KW = dict(matcher_num_layers=1, matcher_num_reg_refine=1)
H, W = 30, 50  # not a multiple of 16: exercises the x32 resize and x16 pad


def _fill(path, shape, rng):
    """Weight-like values for one leaf of the JAX tree."""
    name = path[-1].key
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    if name in ("bias", "mean"):
        return (0.05 * rng.normal(size=shape)).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables():
    model = JDMSCT(**KW)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(model.init, keys, x, x)
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s.shape, rng),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]},
    )


@pytest.fixture(scope="module")
def port(jax_variables):
    model = DMSCT(**KW).eval()
    sd = dmsct_state_dict_from_jax(jax_variables["params"],
                                   jax_variables["batch_stats"])
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    r = np.clip(np.roll(t, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    return t, r


def _close(got, want, rtol=1e-4):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


def test_bridge_round_trips_through_the_jax_converter(port, jax_variables):
    """The port's state_dict, read by the JAX package's convert_dmsct,
    reproduces the JAX tree exactly."""
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, batch_stats = convert_dmsct(sd)
    got = {"params": params, "batch_stats": batch_stats}
    want_flat = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_flat) == len(want_flat)
    for path, value in want_flat:
        np.testing.assert_array_equal(got_flat[path], value)


def test_encoder_pyramid(port, jax_variables, rng):
    x = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    want = JEncoder(depth=4).apply(
        {"params": jax_variables["params"]["encoder"],
         "batch_stats": jax_variables["batch_stats"]["encoder"]},
        jnp.asarray(x),
    )
    with torch.no_grad():
        got = port.encoder(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 32, 48, 3), (2, 16, 24, 32), (2, 8, 12, 24), (2, 4, 6, 48), (2, 2, 3, 120)
    ]
    for g, w in zip(got, want):
        _close(g, w)


def test_decoder_and_head(port, jax_variables, rng):
    chans = [7, 65, 49, 97, 241]  # 2C+1 per level for b2 / depth 4
    feats = [rng.normal(size=(1, 32 >> i, 48 >> i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    p = jax_variables["params"]
    want = JHead(3).apply({"params": p["head"]}, JDecoder((256, 128, 64, 32)).apply(
        {"params": p["decoder"]}, *map(jnp.asarray, feats)))
    with torch.no_grad():
        got = port.head(port.decoder(*map(torch.from_numpy, feats)))
    _close(got, want)


def test_dmsct_end_to_end(port, jax_variables, pair):
    t, r = pair
    model = JDMSCT(**KW)
    want = jax.jit(model.apply)(jax_variables, jnp.asarray(t), jnp.asarray(r))
    size = derive_matcher_size(H, W)
    want_flow = jax.jit(lambda v, a, b: model.apply(
        v, a, b, method=lambda m, x, y: m.matcher(x, y, inference_size=size)
    )["flow"])(jax_variables, jnp.asarray(t) * 255.0, jnp.asarray(r) * 255.0)
    with torch.no_grad():
        got = port(torch.from_numpy(t), torch.from_numpy(r))
        got_flow = port.matcher(torch.from_numpy(t) * 255.0,
                                torch.from_numpy(r) * 255.0,
                                inference_size=size)["flow"]
    assert got.shape == (1, H, W, 3)
    out = got.numpy()
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-3, rtol=0)
    err = float(np.abs(got_flow.numpy() - np.asarray(want_flow)).max())
    scale = float(np.abs(np.asarray(want_flow)).max())
    assert err < max(2e-3, 1e-3 * scale), (err, scale)


KW_FUSED = dict(matcher_num_layers=2, matcher_num_reg_refine=2)


@pytest.fixture(scope="module")
def jax_variables_fused():
    model = JDMSCT(**KW_FUSED)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(model.init, keys, x, x)
    rng = np.random.default_rng(12)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s.shape, rng),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]},
    )


def test_dmsct_fused_route_end_to_end(jax_variables_fused, pair):
    """The fused matcher transformer on the bridged weights: the corrected
    image and the matcher's flow against JAX's interpret route."""
    t, r = pair
    v = jax_variables_fused
    model = JDMSCT(**KW_FUSED, matcher_fused_attention="interpret")
    want = jax.jit(model.apply)(v, jnp.asarray(t), jnp.asarray(r))
    size = derive_matcher_size(H, W)
    want_flow = jax.jit(lambda v_, a, b: model.apply(
        v_, a, b, method=lambda m, x, y: m.matcher(x, y, inference_size=size)
    )["flow"])(v, jnp.asarray(t) * 255.0, jnp.asarray(r) * 255.0)
    port = DMSCT(**KW_FUSED, matcher_fused_attention=True).eval()
    port.load_state_dict(dmsct_state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(t), torch.from_numpy(r))
        got_flow = port.matcher(torch.from_numpy(t) * 255.0, torch.from_numpy(r) * 255.0,
                                inference_size=size)["flow"]
    assert port.matcher.transformer.layers[0].self_attn.fused_attention is True
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    err = float(np.abs(got_flow.numpy() - np.asarray(want_flow)).max())
    scale = float(np.abs(np.asarray(want_flow)).max())
    assert err < max(2e-3, 1e-3 * scale), (err, scale)
