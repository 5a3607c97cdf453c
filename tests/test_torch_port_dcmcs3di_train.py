"""Port parity: DCMCS3DI training (color_transfer_tpu_torch/models/pasm.py's
training half, models/dcmcs3di.py's training forward and losses,
ops/parallax_train.py, run/modules.py::DCMCS3DIModule's train_step) against
color_transfer_tpu, on the weights of test_torch_port_dcmcs3di.py (the JAX
tree filled from a seeded numpy generator, bridged by
``dcmcs3di_state_dict_from_jax``): 8 channels, 3 extraction and 2 transfer
ResB blocks, 16 x 40 images.

Lines:
  * ``pasm.output(inference=False)``: the masks exact, the maps within 1e-4
    of max(1, max|ref|) (f32 on both sides, sums in another order);
  * the PAM losses and ``masked_l1``: rtol 1e-5;
  * ``compute_losses`` / ``compute_losses_fused``: the total rtol 1e-5,
    each part rtol 1e-4, atol 1e-6;
  * gradients (against ``jax.grad``, and the chunked matcher's against the
    materialised one's): rtol 2e-4, atol 1e-5, JAX's own line
    (tests/test_parallax_train.py);
  * ``remat_convs``: bit-equal outputs and gradients;
  * one ``train_step``: the logged losses rtol 1e-5; the first Adam update
    is lr * g / (|g| + eps), about lr * sign(g): where |g| is at least 1e-2
    of its tensor's largest gradient and of the model's largest, the
    updates agree within 2e-7 of max(1, max|p|) (the f32 rounding of p);
    elsewhere a sign may differ and they agree within 2 lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.training import train_state

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.models import pasm as jpasm
from color_transfer_tpu.ops.parallax_train import chunked_parallax_train as j_chunked
from color_transfer_tpu.run.modules import DCMCS3DIModule as JModule
from color_transfer_tpu_torch.models import dcmcs3di as tdc
from color_transfer_tpu_torch.models import pasm as tpasm
from color_transfer_tpu_torch.ops import parallax_train as tpt
from color_transfer_tpu_torch.run.config import build_module
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dcmcs3di import C, EXT, TRA, H, W, params, state_dict  # noqa: F401

LOSS_RTOL, PART_RTOL, PART_ATOL = 1e-5, 1e-4, 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
KW = dict(extraction_layers=EXT, transfer_layers=TRA, channels=C)


def _close(got, want, line=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= line * scale, (err, scale)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    reference = np.clip(np.roll(gt, 3, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.2 * 0.9 + 0.04, 0, 1).astype(np.float32)
    return {"gt": gt, "target": target, "reference": reference}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _costs(rng, b=2, h=6, w=12):
    return tuple(rng.standard_normal((b, h, w, w)).astype(np.float32) * 2 for _ in range(2))


def _leaves(variables):
    return {k: v.detach().clone().requires_grad_(True) for k, v in variables.items()}


@pytest.mark.parametrize("valid_w", [None, 9])
def test_output_training_branch(valid_w):
    costs = _costs(np.random.default_rng(1))
    att, cycle, masks = tpasm.output(tuple(map(torch.from_numpy, costs)), valid_w=valid_w)
    jatt, jcycle, jmasks = jpasm.output(tuple(map(jnp.asarray, costs)), valid_w=valid_w)
    for got, want in zip(att + cycle, jatt + jcycle):
        _close(got, want)
    for got, want in zip(masks, jmasks):
        assert got.dtype == torch.bool and got.shape == (2, 6, 12, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_regress_disp():
    rng = np.random.default_rng(2)
    att = torch.softmax(torch.from_numpy(_costs(rng)[0]) * 3, dim=-1)
    mask = torch.from_numpy((rng.uniform(size=(2, 6, 12, 1)) > 0.4).astype(np.float32))
    got = tpasm.regress_disp(att, mask)
    want = jpasm.regress_disp(jnp.asarray(att.numpy()), jnp.asarray(mask.numpy()))
    assert got.shape == (2, 6, 12, 1)
    _close(got, want)


def test_pam_losses():
    rng = np.random.default_rng(3)
    costs = _costs(rng)
    imgs = [rng.uniform(0, 1, (2, 6, 12, 3)).astype(np.float32) for _ in range(2)]
    att, cycle, masks = tpasm.output(tuple(map(torch.from_numpy, costs)))
    jatt, jcycle, jmasks = jpasm.output(tuple(map(jnp.asarray, costs)))
    t_imgs, j_imgs = [torch.from_numpy(x) for x in imgs], [jnp.asarray(x) for x in imgs]
    pairs = [
        (tpasm.masked_l1(t_imgs[0], t_imgs[1], masks[0]),
         jpasm.masked_l1(j_imgs[0], j_imgs[1], jmasks[0])),
        (tpasm.loss_pam_photometric(*t_imgs, att, masks),
         jpasm.loss_pam_photometric(*j_imgs, jatt, jmasks)),
        (tpasm.loss_pam_cycle(cycle, masks), jpasm.loss_pam_cycle(jcycle, jmasks)),
        (tpasm.loss_pam_smoothness(att), jpasm.loss_pam_smoothness(jatt)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def _chunk_inputs(b=2, h=12, w=16, c=8, seed=0):
    rng = np.random.default_rng(seed)
    x = {k: rng.normal(size=(b, h, w, c)).astype(np.float32)
         for k in ("q_l", "k_l", "q_r", "k_r", "v_r")}
    x["img_l"], x["img_r"] = (rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
                              for _ in range(2))
    return x


def _chunked_total(out):
    warped, _, _, losses = out
    return (warped**2).sum() + losses["photometric"] + losses["cycle"] + losses["smoothness"]


@pytest.mark.parametrize("chunk,used", [(1, 1), (3, 3), (5, 4), (8, 6), (12, 12)])
def test_chunked_parallax_train_matches_jax(chunk, used):
    """Chunks that divide H (12) and that do not (5 -> 4, 8 -> 6): outputs,
    masks and losses, then each input's gradient, against JAX's scan."""
    assert tpt._pick_chunk(12, chunk) == used
    x = _chunk_inputs()
    order = ("q_l", "k_l", "q_r", "k_r", "v_r", "img_l", "img_r")
    scale = 1.0 / 8
    xt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()}
    got = tpt.chunked_parallax_train(*(xt[k] for k in order), scale=scale, chunk=chunk)
    want = j_chunked(*(jnp.asarray(x[k]) for k in order), scale=scale, chunk=chunk)
    _close(got[0], want[0])
    for i in (1, 2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for k in want[3]:
        np.testing.assert_allclose(float(got[3][k].detach()), float(want[3][k]), rtol=LOSS_RTOL)
    grads = torch.autograd.grad(_chunked_total(got), [xt[k] for k in order])
    jgrads = jax.grad(lambda a: _chunked_total(j_chunked(*a, scale=scale, chunk=chunk)))(
        tuple(jnp.asarray(x[k]) for k in order))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_chunked_matches_materialised():
    """The chunked matcher against the materialised pasm path in the port:
    outputs, masks, losses and gradients (JAX's test_parallax_train)."""
    x = _chunk_inputs(b=1, h=8, w=12, c=6, seed=1)
    order = ("q_l", "k_l", "q_r", "k_r", "v_r", "img_l", "img_r")
    scale = 1.0 / 6
    xt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()}

    def materialised():
        costs = (torch.einsum("bhwc,bhvc->bhwv", xt["q_l"], xt["k_r"]) * scale,
                 torch.einsum("bhwc,bhvc->bhwv", xt["q_r"], xt["k_l"]) * scale)
        att, cycle, masks = tpasm.output(costs)
        losses = {"photometric": tpasm.loss_pam_photometric(xt["img_l"], xt["img_r"], att,
                                                            masks),
                  "cycle": tpasm.loss_pam_cycle(cycle, masks),
                  "smoothness": tpasm.loss_pam_smoothness(att)}
        return tpasm.warp(xt["v_r"], att[0]), masks[0], masks[1], losses

    want = materialised()
    got = tpt.chunked_parallax_train(*(xt[k] for k in order), scale=scale, chunk=3)
    _close(got[0], want[0].detach())
    for i in (1, 2):
        np.testing.assert_array_equal(got[i].numpy(), want[i].numpy())
    for k in want[3]:
        np.testing.assert_allclose(float(got[3][k].detach()), float(want[3][k]),
                                   rtol=LOSS_RTOL, atol=PART_ATOL)
    g_c = torch.autograd.grad(_chunked_total(got), [xt[k] for k in order])
    g_m = torch.autograd.grad(_chunked_total(want), [xt[k] for k in order])
    for a, b in zip(g_c, g_m):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _port_losses(state_dict, batch, fused, remat=False):
    """(total, parts, corrected, {name: gradient}) of the port's training
    forward on the bridged variables."""
    model = tdc.DCMCS3DI(**KW, remat_convs=remat)
    variables = _leaves(state_dict)
    b = _t(batch)
    if fused:
        corrected, pam = torch.func.functional_call(
            model, variables, (b["target"], b["reference"]), {"chunk": 4})
        total, parts = tdc.compute_losses_fused(corrected, pam, b)
    else:
        out = torch.func.functional_call(model, variables, (b["target"], b["reference"]))
        total, parts = tdc.compute_losses(out, b)
        corrected = out[0]
    grads = torch.autograd.grad(total, list(variables.values()))
    return total, parts, corrected, dict(zip(variables, grads))


def _jax_losses(params, batch, fused):
    model = jdc.DCMCS3DI(**KW)
    b = _j(batch)

    def loss(p):
        if fused:
            corrected, pam = model.apply({"params": p}, b["target"], b["reference"], chunk=4,
                                         method=model.fused_train_forward)
            total, parts = jdc.compute_losses_fused(corrected, pam, b)
        else:
            out = model.apply({"params": p}, b["target"], b["reference"])
            total, parts = jdc.compute_losses(out, b)
            corrected = out[0]
        return total, (parts, corrected)

    (total, (parts, corrected)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return total, parts, corrected, grads


@pytest.mark.parametrize("fused", [False, True], ids=["materialised", "chunked"])
def test_losses_and_gradients_match_jax(params, state_dict, batch, fused):
    total, parts, corrected, grads = _port_losses(state_dict, batch, fused)
    jtotal, jparts, jcorrected, jgrads = _jax_losses(params, batch, fused)
    _close(corrected, jcorrected)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    assert set(parts) == set(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=PART_RTOL,
                                   atol=PART_ATOL, err_msg=k)
    want = dcmcs3di_state_dict_from_jax(jgrads)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_chunked_model_gradients_match_materialised(state_dict, batch):
    total_m, parts_m, _, g_m = _port_losses(state_dict, batch, fused=False)
    total_c, parts_c, _, g_c = _port_losses(state_dict, batch, fused=True)
    np.testing.assert_allclose(float(total_c), float(total_m), rtol=LOSS_RTOL)
    for k, g in g_c.items():
        np.testing.assert_allclose(g.numpy(), g_m[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["materialised", "chunked"])
def test_remat_convs_bit_equal(state_dict, batch, fused):
    """Rematerialised ResB stacks: the same state_dict names, outputs and
    gradients bit for bit, on variables that are not the module's own (the
    recompute must use the call's weights)."""
    assert (set(tdc.DCMCS3DI(**KW, remat_convs=True).state_dict())
            == set(tdc.DCMCS3DI(**KW).state_dict()))
    total, _, corrected, grads = _port_losses(state_dict, batch, fused)
    total_r, _, corrected_r, grads_r = _port_losses(state_dict, batch, fused, remat=True)
    assert torch.equal(total, total_r) and torch.equal(corrected, corrected_r)
    for k, g in grads.items():
        assert torch.equal(g, grads_r[k]), k


@pytest.mark.parametrize("inference", [True, False])
def test_valid_w_matches_jax(params, state_dict, batch, inference):
    """Columns at or beyond valid_w take no attention: the corrected image,
    the attention maps and the masks against JAX's."""
    model = tdc.DCMCS3DI(**KW).eval()
    model.load_state_dict(state_dict)
    b = _t(batch)
    with torch.no_grad():
        out, aux = model(b["target"], b["reference"], inference=inference, valid_w=29)
    want, jaux = jdc.DCMCS3DI(**KW).apply({"params": params}, jnp.asarray(batch["target"]),
                                          jnp.asarray(batch["reference"]),
                                          inference=inference, valid_w=jnp.int32(29))
    _close(out, want)
    assert float(aux[0][0][..., 29:].abs().max()) == 0.0
    for got, ref in zip(aux[0], jaux[0]):
        _close(got, ref)
    np.testing.assert_array_equal(aux[2][0].numpy(), np.asarray(jaux[2][0]))
    _close(aux[3], jaux[3])


def _jax_step(params, batch, fused):
    jmod = JModule(**KW, heavy_metrics=False, fused_attention=fused, attention_chunk=4)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(batch["target"])}
    state = train_state.TrainState.create(apply_fn=jmod.model.apply, params=params,
                                          tx=optax.adam(jmod.learning_rate))
    new, logs = jmod.train_step(state, {"gt": jnp.asarray(batch["gt"]),
                                        "reference": jnp.asarray(batch["reference"])},
                                jax.random.PRNGKey(0))
    return dcmcs3di_state_dict_from_jax(new.params), {k: float(v) for k, v in logs.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["materialised", "chunked"])
def test_train_step_matches_jax(params, state_dict, batch, fused):
    new_j, logs_j = _jax_step(params, batch, fused)
    module = DCMCS3DIModule(**KW, heavy_metrics=False, fused_attention=fused,
                            attention_chunk=4)
    b = _t(batch)
    state = module.init_state(0, b, num_train_steps=7)
    with torch.no_grad():
        for k, v in state.variables.items():
            v.copy_(state_dict[k])
    module.synthesize_targets = lambda bb, gen: {**bb, "target": b["target"]}
    state, logs = module.train_step(state, {"gt": b["gt"], "reference": b["reference"]},
                                    seed=0)
    assert state.step == 1
    assert set(logs) == set(logs_j) and "Training Total Loss" in logs
    for k, v in logs.items():
        np.testing.assert_allclose(float(v), logs_j[k], rtol=LOSS_RTOL, err_msg=k)
    _, _, _, grads = _jax_losses(params, batch, fused)
    grads = dcmcs3di_state_dict_from_jax(grads)
    g_max = max(float(g.abs().max()) for g in grads.values())
    lr = module.learning_rate
    for k, v in state.variables.items():
        got, want, g = v.detach(), new_j[k], grads[k].abs()
        big = (g >= 1e-2 * float(g.max())) & (g >= 1e-2 * g_max)
        line = 2e-7 * max(1.0, float(state_dict[k].abs().max()))
        assert float(torch.where(big, got - want, 0.0).abs().max()) <= line, k
        assert float((got - want).abs().max()) <= 2 * lr, k


def test_module_keywords_and_registry(batch):
    """Every keyword of JAX's module and of configs/dcmcs3di.yaml; the
    class paths; the bf16 recipe trains: a finite loss, f32 variables that
    moved (its parity: test_torch_port_dcmcs3di_bf16_train.py)."""
    module = build_module("methods.dcmcs3di.DCMCS3DI", dict(
        KW, learning_rate=2e-4, heavy_metrics=False, fused_attention=False,
        attention_chunk=3, compute_dtype=None, remat_convs=True))
    assert isinstance(module, DCMCS3DIModule) and module.supports_valid_w
    assert module.hparams == dict(KW, learning_rate=2e-4, fused_attention=False,
                                  compute_dtype=None, remat_convs=True)
    assert module.model.extraction.remat and module.attention_chunk == 3
    state = module.init_state(0, _t(batch))
    assert isinstance(state.optimizer, torch.optim.Adam)
    group = state.optimizer.param_groups[0]
    assert group["lr"] == 2e-4 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    bf16 = DCMCS3DIModule(**KW, compute_dtype="bfloat16")
    state = bf16.init_state(0, _t(batch))
    before = {k: v.detach().clone() for k, v in state.variables.items()}
    state, logs = bf16.train_step(state, _t(batch), seed=0)
    assert np.isfinite(float(logs["Training Total Loss"]))
    assert all(v.dtype == torch.float32 for v in state.variables.values())
    assert any(not torch.equal(v.detach(), before[k]) for k, v in state.variables.items())


def test_train_step_forward_leaves_cudnn(batch, monkeypatch):
    """The training forward runs with cuDNN off (its f32 forward algorithms
    put the card's gradients past the float64 rule, chip_smoke.py phase 10);
    the backward and the caller's setting are left as they were."""
    module = DCMCS3DIModule(**KW, heavy_metrics=False)
    seen = []
    forward_loss = module.forward_loss

    def spy(state, b):
        seen.append(torch.backends.cudnn.enabled)
        return forward_loss(state, b)

    monkeypatch.setattr(module, "forward_loss", spy)
    before = torch.backends.cudnn.enabled
    module.train_step(module.init_state(0, _t(batch)), _t(batch), seed=0, metrics=False)
    assert seen == [False] and torch.backends.cudnn.enabled == before
