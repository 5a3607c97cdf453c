"""Port parity: image panels (color_transfer_tpu_torch/utils/
visualizations.py, flow_viz.py, ``image_panels`` of both deep modules)
against color_transfer_tpu on the CPU.

Lines:
  * every ``visualizations`` function within 1e-5 of JAX's on the same
    seeded images (f32 on both sides; Lab and the SSIM map's blurs sum in
    another order). The error maps are min-max scaled: dividing by the
    unscaled map's range r multiplies a difference by 1 / r, so the line
    holds on the unscaled map, 1e-5 / r after the scaling (for rgbssim on
    these images r ~ 0.0104 and its largest difference 1.6e-5 after the
    scaling, 1.7e-7 before it);
  * ``flow_viz``: exact (the same numpy code on the same flow);
  * DCMCS3DI's panels on shared weights (test_torch_port_dcmcs3di.py's
    tree, bridged): the keys and shapes JAX's; the images within 1e-4, the
    model's end-to-end line, and the disparity (min-max scaled) within 1e-3;
  * DMSCT's panels: JAX's matcher is chaotic at random init (ROADMAP,
    "Chaos at random init"), so both sides are fed one flow and occlusion
    mask in place of their matcher's; the keys and shapes JAX's, each
    panel within 1e-4 (the corrector's f32 on both sides; min-max-scaled
    error maps within 1e-4 of their [0, 1] range).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import gmflow as jgmflow
from color_transfer_tpu.run import modules as jmodules
from color_transfer_tpu.utils import flow_viz as jflow_viz
from color_transfer_tpu.utils import visualizations as jviz
from color_transfer_tpu_torch.models import gmflow as tgmflow
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule
from color_transfer_tpu_torch.tools.convert import (
    dcmcs3di_state_dict_from_jax,
    dmsct_state_dict_from_jax,
)
from color_transfer_tpu_torch.utils import flow_viz, visualizations as viz
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dcmcs3di import C, EXT, TRA
from test_torch_port_dcmcs3di import params as dc_params  # noqa: F401  (a fixture)
from test_torch_port_dmsct import KW, jax_variables  # noqa: F401  (a fixture)

H, W = 30, 50


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", ["chess_mix", "minmaxscale", "rgbmse", "labmse", "abmse",
                                  "rgbssim"])
def test_visualizations_match_jax(images, name, monkeypatch):
    x, y = images
    args = (x,) if name == "minmaxscale" else (x, y)
    ranges = []
    if name.endswith(("mse", "ssim")):  # the unscaled map's range, per image
        scale = jviz.minmaxscale
        monkeypatch.setattr(jviz, "minmaxscale", lambda m: ranges.append(
            np.asarray(m.max(axis=(-1, -2)) - m.min(axis=(-1, -2)))) or scale(m))
    want = np.asarray(getattr(jviz, name)(*map(jnp.asarray, args)))
    got = getattr(viz, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    line = 1e-5 / (ranges[0][:, None, None, None] if ranges else 1.0)
    assert (np.abs(got - want) <= line).all(), float(np.abs(got - want).max())


def test_chess_mix_cells():
    x, y = torch.zeros(1, 60, 60, 3), torch.ones(1, 60, 60, 3)
    out = viz.chess_mix(x, y, size=25)
    assert out[0, 0, 0, 0] == 0 and out[0, 0, 25, 0] == 1 and out[0, 25, 25, 0] == 0


def test_flow_viz_matches_jax(rng):
    np.testing.assert_array_equal(flow_viz.make_color_wheel(), jflow_viz.make_color_wheel())
    flow = rng.normal(0, 4, (3, 17, 23, 2)).astype(np.float32)
    flow[0, 0, 0] = np.nan
    flow[1, 2, 3, 0] = 2e7  # unknown flow
    for f in flow:
        np.testing.assert_array_equal(flow_viz.flow_to_image(f), jflow_viz.flow_to_image(f))
        np.testing.assert_array_equal(flow_viz.flow_to_image(f, rad_max=3.0),
                                      jflow_viz.flow_to_image(f, rad_max=3.0))
    u, v = flow[2, ..., 0] / 10, flow[2, ..., 1] / 10
    np.testing.assert_array_equal(flow_viz.compute_color(u, v), jflow_viz.compute_color(u, v))
    want = jflow_viz.flow_batch_to_images(flow)
    np.testing.assert_array_equal(flow_viz.flow_batch_to_images(flow), want)
    np.testing.assert_array_equal(flow_viz.flow_batch_to_images(torch.from_numpy(flow)), want)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
    ref = np.clip(np.roll(gt, 2, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.2 * 0.9 + 0.04, 0, 1).astype(np.float32)
    return {"gt": gt, "reference": ref, "target": target}


def _check_panels(got, want, lines):
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape == (H, W, 3), k
        assert np.isfinite(g).all() and g.min() >= 0 and g.max() <= 1, k
        np.testing.assert_allclose(g, w, atol=lines.get(k, 1e-4), rtol=0, err_msg=k)


def test_dcmcs3di_panels_match_jax(dc_params):
    from types import SimpleNamespace

    batch = _batch(3)
    jmod = jmodules.DCMCS3DIModule(extraction_layers=EXT, transfer_layers=TRA, channels=C)
    want = jmod.image_panels(SimpleNamespace(params=dc_params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    port = DCMCS3DIModule(extraction_layers=EXT, transfer_layers=TRA, channels=C)
    state = SimpleNamespace(variables=dcmcs3di_state_dict_from_jax(dc_params))
    got = port.image_panels(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _check_panels(got, want, {"Disparity": 1e-3})


def test_dmsct_panels_match_jax_on_a_fed_flow(jax_variables, monkeypatch):
    from types import SimpleNamespace

    batch = _batch(4)
    rng = np.random.default_rng(8)
    flow = rng.normal(0, 2, (1, H, W, 2)).astype(np.float32)
    occ = (rng.uniform(size=(1, H, W, 1)) > 0.8).astype(np.float32)
    fed = {"flow": flow, "flow_bwd": -flow, "fwd_occ": occ, "bwd_occ": occ}
    monkeypatch.setattr(jgmflow.GMFlow, "__call__",
                        lambda self, *a, **k: {n: jnp.asarray(v) for n, v in fed.items()})
    monkeypatch.setattr(tgmflow.GMFlow, "forward",
                        lambda self, *a, **k: {n: torch.from_numpy(v) for n, v in fed.items()})
    jmod = jmodules.DMSCTModule(**KW)
    want = jmod.image_panels(SimpleNamespace(params=jax_variables["params"],
                                             batch_stats=jax_variables["batch_stats"]),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    port = DMSCTModule(**KW)
    state = SimpleNamespace(variables=dmsct_state_dict_from_jax(
        jax_variables["params"], jax_variables["batch_stats"]))
    got = port.image_panels(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _check_panels(got, want, {})
    np.testing.assert_array_equal(got["Optical Flow"].numpy() * 255.0,
                                  jflow_viz.flow_batch_to_images(flow)[0].astype(np.float32))


def test_dmsct_panels_own_matcher_keys_and_shapes(jax_variables):
    """Without a fed flow (each side its own matcher): JAX's keys and
    shapes, finite panels in [0, 1]."""
    from types import SimpleNamespace

    batch = _batch(5)
    want = jmodules.DMSCTModule(**KW).image_panels(
        SimpleNamespace(params=jax_variables["params"],
                        batch_stats=jax_variables["batch_stats"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = DMSCTModule(**KW).image_panels(
        SimpleNamespace(variables=dmsct_state_dict_from_jax(
            jax_variables["params"], jax_variables["batch_stats"])),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(w) and np.isfinite(g).all(), k
        assert g.min() >= 0 and g.max() <= 1, k
