"""Port parity: DCMCS3DI inference (color_transfer_tpu_torch/models/layers.py,
pasm.py, dcmcs3di.py) and its weight bridge (tools/convert.py) against
color_transfer_tpu.

The JAX parameters are the JAX model's own tree (its structure from
``jax.eval_shape(model.init, ...)``), filled from a seeded numpy generator
with the JAX init's law, U(+-1/sqrt(fan_in)); they reach the port through
``dcmcs3di_state_dict_from_jax``. Small shapes: 8 channels, 2 extraction
and 1 transfer ResB blocks (3 and 2 for the model), 16 x 40 images. The
JAX kernels run in interpret mode.

Lines, relative to s = max(1, max|ref|):
  * f32: max|d| <= 1e-4 s for every stage and for the model end to end
    (f32 on both sides, sums in another order);
  * bf16 stages (Conv, ResB, Extractor, TransferNet, plain and fused):
    max|d| <= s / 32. Both sides round to bf16 at the same places; a
    different f32 sum order flips a rounding by one ulp (2^-8 relative)
    now and then, and later convs carry it along;
  * bf16 model end to end (image in [0, 1]): atol 8e-3, two bf16 ulps of
    an output near 1 (2^-8 each; a flip in the last bf16 conv reaches the
    image unscaled).
The valid masks agree exactly on the f32 routes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.models import layers as jlayers
from color_transfer_tpu.models import pasm as jpasm
from color_transfer_tpu.tools.convert_checkpoints import convert_dcmcs3di
from color_transfer_tpu_torch.models import dcmcs3di as tdc
from color_transfer_tpu_torch.models import layers as tlayers
from color_transfer_tpu_torch.models import pasm as tpasm
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax

C, EXT, TRA = 8, 3, 2
H, W = 16, 40
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _fill(path, shape, rng):
    """The JAX init's law: kernel and bias U(+-1/sqrt(fan_in)); a bias's
    fan_in is its kernel's, kh * kw * C_in, unknown here, so biases take
    the bound of a 3x3 conv over C channels."""
    fan_in = int(np.prod(shape[:-1])) if path[-1].key == "kernel" else 9 * C
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    model = jdc.DCMCS3DI(extraction_layers=EXT, transfer_layers=TRA, channels=C)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(21)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s.shape, rng), shapes)


@pytest.fixture(scope="module")
def state_dict(params):
    return dcmcs3di_state_dict_from_jax(params)


def _port(state_dict, dtype=None):
    model = tdc.DCMCS3DI(EXT, TRA, C, compute_dtype=dtype).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    r = np.clip(np.roll(t, 3, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    return t, r


def _close(got, want, dtype="f32"):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = max(1.0, np.abs(want).max())
    assert err <= (1e-4 if dtype == "f32" else 1 / 32) * scale, (err, scale)


def test_bridge_round_trips(params, state_dict):
    """The port's state_dict converts back to the JAX tree exactly."""
    back = convert_dcmcs3di({k: v.numpy() for k, v in state_dict.items()},
                            extraction_layers=EXT, transfer_layers=TRA)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_back] == [p for p, _ in flat]
    for (_, a), (_, b) in zip(flat_back, flat):
        np.testing.assert_array_equal(a, b)
    model = tdc.DCMCS3DI(EXT, TRA, C)
    assert set(state_dict) == set(model.state_dict())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_and_resb(params, state_dict, dtype, rng):
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    stem = tlayers.Conv(C, C, dtype=td)
    prefix = "extraction.1.body.0."
    stem.load_state_dict({k[len(prefix):]: v for k, v in state_dict.items()
                          if k.startswith(prefix)})
    want = jlayers.Conv(C, dtype=jd).apply(
        {"params": params["extraction"]["ResB_0"]["Conv_0"]}, jnp.asarray(x))
    _close(stem(torch.from_numpy(x)), want, dtype)
    blk = tlayers.ResB(C, dtype=td)
    blk.load_state_dict({k[len("extraction.1."):]: v for k, v in state_dict.items()
                         if k.startswith("extraction.1.")})
    want = jlayers.ResB(C, dtype=jd).apply(
        {"params": params["extraction"]["ResB_0"]}, jnp.asarray(x).astype(jd or jnp.float32))
    with torch.no_grad():
        _close(blk(torch.from_numpy(x).to(td or torch.float32)), want, dtype)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_extractor_and_transfer(params, state_dict, pair, dtype, fused, rng):
    jd, td = DTYPES[dtype]
    port = _port(state_dict, td)
    x = np.concatenate(pair, axis=0)
    jext = jdc.Extractor(C, EXT, dtype=jd)
    kw = dict(method=jdc.Extractor.fused, interpret=True) if fused else {}
    want = jext.apply({"params": params["extraction"]}, jnp.asarray(x), **kw)
    with torch.no_grad():
        ext = port.extraction
        got = ext.fused(torch.from_numpy(x)) if fused else ext(torch.from_numpy(x))
    _close(got, want, dtype)

    cat = rng.uniform(-1, 1, (1, H, W, 2 * C + 1)).astype(np.float32)
    jtra = jdc.TransferNet(C, TRA, dtype=jd)
    kw = dict(method=jdc.TransferNet.fused, interpret=True) if fused else {}
    want = jtra.apply({"params": params["transfer"]}, jnp.asarray(cat), **kw)
    with torch.no_grad():
        tra = port.transfer
        got = tra.fused(torch.from_numpy(cat)) if fused else tra(torch.from_numpy(cat))
    _close(got, want, dtype)


def test_pab_output_warp(params, state_dict, rng):
    port = _port(state_dict)
    xl, xr = (rng.standard_normal((1, H, W, C)).astype(np.float32) for _ in range(2))
    jpab = jpasm.PAB(C)
    jcosts = jpab.apply({"params": params["matcher"]}, jnp.asarray(xl), jnp.asarray(xr))
    with torch.no_grad():
        costs = port.matcher(torch.from_numpy(xl), torch.from_numpy(xr))
        for got, want in zip(costs, jcosts):
            _close(got, want)
        att, cycle, masks = tpasm.output(costs, inference=True)
        jatt, jcycle, jmasks = jpasm.output(jcosts, inference=True)
        for got, want in zip(att, jatt):
            _close(got, want)
        assert cycle == (None, None) and masks[1] is None and jmasks[1] is None
        np.testing.assert_array_equal(masks[0].numpy(), np.asarray(jmasks[0]))
        value = jpab.apply({"params": params["matcher"]}, jnp.asarray(xr),
                           method=jpasm.PAB.value_features)
        _close(port.matcher.value_features(torch.from_numpy(xr)), value)
        _close(tpasm.warp(torch.from_numpy(np.array(value)), att[0]),
               jpasm.warp(value, jatt[0]))
        # The training branch: the cycle maps and both masks.
        att, cycle, masks = tpasm.output(costs, inference=False)
        jatt, jcycle, jmasks = jpasm.output(jcosts, inference=False)
        for got, want in zip(att + cycle, jatt + jcycle):
            _close(got, want)
        for got, want in zip(masks, jmasks):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ROUTES = {  # name: (port kwargs, JAX kwargs)
    "materialised": ({}, {}),
    "kernels": ({"use_kernels": True, "precise": True},
                {"use_pallas": True, "pallas_precise": True}),
    "kernels_bf16_operands": ({"use_kernels": True}, {"use_pallas": True}),
    "kernels_fused_f32": ({"use_kernels": True, "precise": True, "fused_extraction": True},
                          {"use_pallas": True, "pallas_precise": True,
                           "fused_extraction": True}),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_end_to_end(params, state_dict, pair, dtype, route):
    jd, td = DTYPES[dtype]
    tkw, jkw = ROUTES[route]
    t, r = pair
    jmodel = jdc.DCMCS3DI(EXT, TRA, C, compute_dtype=jd)
    if "use_pallas" in jkw:
        jkw = {**jkw, "pallas_interpret": True}
    want, jaux = jmodel.apply({"params": params}, jnp.asarray(t), jnp.asarray(r),
                              inference=True, **jkw)
    with torch.no_grad():
        got, aux = _port(state_dict, td)(torch.from_numpy(t), torch.from_numpy(r),
                                         inference=True, **tkw)
    assert got.dtype == torch.float32 and got.shape == (1, H, W, 3)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    if dtype == "f32":
        assert err <= 1e-4, err
        if route != "kernels_bf16_operands":
            np.testing.assert_array_equal(aux[2][0].numpy(), np.asarray(jaux[2][0]))
    else:
        assert err <= 8e-3, err
    if route == "materialised":
        _close(aux[3], jaux[3], dtype)  # the warped right view
    else:
        assert aux[0] == (None, None) and aux[3] is None


@pytest.mark.parametrize("dtype,use_kernels,fused,calls", [
    ("f32", True, None, 0),    # auto: off in f32
    ("bf16", True, None, 2),   # auto: on for the kernel route in bf16
    ("bf16", False, None, 0),  # auto: off on the materialised route
    ("f32", True, True, 2),    # explicit: on in f32 too
])
def test_fused_extraction_rule(state_dict, pair, monkeypatch, dtype, use_kernels,
                               fused, calls):
    seen = []
    real = tdc.resb_chain

    def counting(*args, **kwargs):
        seen.append(args[-1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdc, "resb_chain", counting)
    td = DTYPES[dtype][1]
    t, r = (torch.from_numpy(a) for a in pair)
    with torch.no_grad():
        _port(state_dict, td)(t, r, inference=True, use_kernels=use_kernels,
                              fused_extraction=fused)
    assert len(seen) == calls  # extraction stack + transfer stack
    assert all(d == (td or torch.float32) for d in seen)


def test_training_forward_matches_jax(params, state_dict, pair):
    """``inference=False``: the corrected image and the whole aux (both
    attention maps, both cycle maps, both masks, the warped right view)
    against JAX's training call."""
    t, r = pair
    want, jaux = jdc.DCMCS3DI(EXT, TRA, C).apply({"params": params}, jnp.asarray(t),
                                                 jnp.asarray(r))
    with torch.no_grad():
        got, aux = _port(state_dict)(torch.from_numpy(t), torch.from_numpy(r))
    _close(got, want)
    for pair_got, pair_want in zip(aux[:2], jaux[:2]):
        for g, w in zip(pair_got, pair_want):
            _close(g, w)
    for g, w in zip(aux[2], jaux[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(aux[3], jaux[3])
