"""Port parity: DMSCT training pieces against color_transfer_tpu — the
encoder in train mode (batch statistics, their running update), the DMSCT
train forward, loss and gradient, drop-connect's law, and AdamW with the
cosine schedule against optax.

The JAX variables are the JAX model's own tree filled from a seeded numpy
generator; they reach the port through ``dmsct_state_dict_from_jax`` (the
gradients too: a gradient tree has the parameters' layout). Drop-connect is
off on both sides (JAX draws its masks from ``jax.random``): the JAX side
gets ``EfficientNetEncoder(drop_connect_rate=0.0)`` through a monkeypatch
of the name color_transfer_tpu.models.dmsct looks up, the port sets
``encoder.drop_connect_rate = 0``. Both sides see the same targets.

Lines: encoder features 1e-4 of max(1, max|ref|); running statistics
after one call 1e-5 relative (the biased variance, flax's update); the loss
1e-5 relative; every gradient within 1e-4 of its tensor's scale, max|ref|
with a floor of 1e-2 of the largest gradient of the model (a BatchNorm bias
that feeds only train-mode BatchNorms has a gradient that vanishes
analytically, so both sides hold rounding noise there); the optimizer's
parameters after 3 steps within 1e-6.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import color_transfer_tpu.models.dmsct as jdmsct
from color_transfer_tpu.models.efficientnet import EfficientNetEncoder as JEncoder
from color_transfer_tpu.run.modules import DMSCTModule as JModule
from color_transfer_tpu_torch.models.dmsct import DMSCT, compute_losses
from color_transfer_tpu_torch.models.efficientnet import EfficientNetEncoder, drop_connect
from color_transfer_tpu_torch.run.modules import DMSCTModule, cosine_decay
from color_transfer_tpu_torch.tools.convert import (
    _efficientnet,
    _StateDict,
    dmsct_state_dict_from_jax,
)
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

KW = dict(matcher_num_layers=1, matcher_num_reg_refine=1)
B, H, W = 2, 32, 48


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


@pytest.fixture(scope="module")
def jax_variables():
    model = jdmsct.DMSCT(**KW)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(model.init, keys, x, x)
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s.shape, rng),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]},
    )


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    reference = np.clip(np.roll(gt, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.3 * 0.9 + 0.04, 0, 1).astype(np.float32)
    return {"gt": gt, "reference": reference, "target": target}


def _state_dict(tree, batch_stats):
    return dmsct_state_dict_from_jax(tree, batch_stats)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _check_grads(got, want):
    """got, want: name -> gradient (numpy); the gradient line above."""
    floor = 1e-2 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[name] - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


# -- encoder --------------------------------------------------------------


def test_encoder_train_forward_grad_and_stats(jax_variables, rng):
    p = jax_variables["params"]["encoder"]
    s = jax_variables["batch_stats"]["encoder"]
    x = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    weights = [rng.normal(size=(2, 32 >> i, 48 >> i, c)).astype(np.float32)
               for i, c in enumerate((3, 32, 24, 48, 120))]
    jenc = JEncoder(depth=4, drop_connect_rate=0.0)

    def loss(params):
        feats, upd = jenc.apply({"params": params, "batch_stats": s}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
        return sum(jnp.sum(f * w) for f, w in zip(feats, weights)), (feats, upd)

    (_, (want_feats, upd)), want_grad = jax.value_and_grad(loss, has_aux=True)(p)

    enc = EfficientNetEncoder("efficientnet-b2", 4, drop_connect_rate=0.0)
    sd = _StateDict()
    _efficientnet(sd, "enc", p, s, "efficientnet-b2", 4)
    enc.load_state_dict({k[len("enc."):]: v for k, v in sd.items()}, strict=True)
    feats = enc(torch.from_numpy(x), train=True)
    total = sum((f * torch.from_numpy(w)).sum() for f, w in zip(feats, weights))
    total.backward()
    for f, w in zip(feats, want_feats):
        assert _rel(f.detach().numpy(), w) <= 1e-4
    grad_sd = _StateDict()
    _efficientnet(grad_sd, "enc", want_grad, upd["batch_stats"], "efficientnet-b2", 4)
    got_params = dict(enc.named_parameters())
    want = {k[len("enc."):]: v.numpy() for k, v in grad_sd.items()}
    _check_grads({k: p.grad.numpy() for k, p in got_params.items()},
                 {k: v for k, v in want.items() if k in got_params})
    for key, want in grad_sd.items():
        name = key[len("enc."):]
        if name.endswith(("running_mean", "running_var")):
            # Running statistics after one train call: flax's update with
            # the biased batch variance.
            got = enc.state_dict()[name].numpy()
            err = np.abs(got - want.numpy()).max() / np.abs(want.numpy()).max()
            assert err <= 1e-5, (name, err)


def test_bn_eval_mode_is_unchanged(jax_variables, rng):
    """train=False normalises with the running statistics and leaves them."""
    enc = EfficientNetEncoder("efficientnet-b2", 4)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    enc(torch.from_numpy(rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)))
    assert all(torch.equal(before[k], v) for k, v in enc.state_dict().items())


def test_drop_connect_law():
    """Per-sample masks: kept with probability 1 - rate, scaled by
    1 / (1 - rate), one draw per sample, seeded."""
    x = torch.ones(20000, 3, 2, 2)
    out = drop_connect(x, 0.25, torch.Generator().manual_seed(0))
    per_sample = out.reshape(20000, -1)
    assert torch.all(per_sample == per_sample[:, :1])  # one draw per sample
    values = set(per_sample[:, 0].tolist())
    assert values <= {0.0, float(torch.tensor(1.0 / 0.75))}
    kept = float((per_sample[:, 0] > 0).float().mean())
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / 20000) ** 0.5
    again = drop_connect(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_encoder_drop_rates_follow_jax():
    """Rate 0.2 * block / total blocks of the whole b2 (23 blocks), applied
    only on the skip blocks, only in train mode."""
    enc = EfficientNetEncoder("efficientnet-b2", 4)
    assert enc.total_blocks == 23 and len(enc._blocks) == 16
    x = torch.rand(64, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = enc(x, train=True, generator=torch.Generator().manual_seed(2))
        b = enc(x, train=True, generator=torch.Generator().manual_seed(2))
        c = enc(x, train=True, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[-1], c[-1])


# -- DMSCT loss and gradient -------------------------------------------------


def fed_matcher_output(seed=0):
    """Flow (B, H, W, 2) and forward occlusion (B, H, W, 1), numpy."""
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=(B, H, W, 2)) * 2.5
    far = rng.uniform(size=(B, H, W, 1)) < 0.1
    flow = np.where(far, np.sign(flow) * 60.0, flow)
    flow = np.where(rng.uniform(size=(B, H, W, 1)) < 0.05, 0.0, flow)
    occ = (rng.uniform(size=(B, H, W, 1)) < 0.1).astype(np.float32)
    return {"flow": flow.astype(np.float32), "fwd_occ": occ}


class _FedMatcher(nn.Module):
    """Stands in for the JAX GMFlow in DMSCT: returns FED's outputs."""

    num_transformer_layers: int = 6
    num_reg_refine: int = 6
    corr_dtype: object = None
    compute_dtype: object = None
    fused_attention: object = None
    refine_dtype: object = None

    @nn.compact
    def __call__(self, img0, img1, **kwargs):
        return {k: jnp.asarray(v) for k, v in FED.items()}


FED = fed_matcher_output()


def feed_matcher(model, matcher_out):
    """Make ``model.matcher`` return ``matcher_out`` (its computation still
    runs). Returns the hook handle."""
    fed = {k: torch.from_numpy(v) for k, v in matcher_out.items()}
    return model.matcher.register_forward_hook(lambda m, a, o: fed)


@pytest.fixture
def jax_fed_dmsct(monkeypatch):
    """The JAX DMSCT name space with the fed matcher and drop-connect off."""
    monkeypatch.setattr(jdmsct, "GMFlow", _FedMatcher)
    monkeypatch.setattr(jdmsct, "EfficientNetEncoder",
                        functools.partial(JEncoder, drop_connect_rate=0.0))
    return jdmsct


def jax_loss_and_grad(jdm, variables, batch):
    """JAX's loss, its parts, the gradient and the new batch statistics."""
    model = jdm.DMSCT(**KW)
    stats = variables["batch_stats"]

    def loss_fn(params):
        result, upd = model.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(batch["target"]),
            jnp.asarray(batch["reference"]), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)},
        )
        total, parts = jdm.compute_losses(result, jnp.asarray(batch["gt"]))
        return total, (parts, upd["batch_stats"])

    (total, (parts, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(total), {k: float(v) for k, v in parts.items()}, grads, new_stats


def test_dmsct_loss_and_gradient(jax_variables, batch, jax_fed_dmsct):
    total_j, parts_j, grads_j, stats_j = jax_loss_and_grad(jax_fed_dmsct, jax_variables,
                                                           batch)
    model = DMSCT(**KW)
    model.load_state_dict(_state_dict(jax_variables["params"], jax_variables["batch_stats"]))
    model.encoder.drop_connect_rate = 0.0
    feed_matcher(model, FED)
    for name, p in model.named_parameters():
        p.requires_grad_(not name.startswith("matcher."))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    result = model(t["target"], t["reference"], train=True)
    total, parts = compute_losses(result, t["gt"])
    total.backward()
    assert abs(total.item() - total_j) <= 1e-5 * abs(total_j)
    for k, v in parts.items():
        assert abs(v.item() - parts_j[k]) <= 1e-5 * abs(parts_j[k]), k
    want = _state_dict(grads_j, stats_j)
    got = {}
    for name, p in model.named_parameters():
        if name.startswith("matcher."):
            assert p.grad is None
        else:
            got[name] = p.grad.numpy()
    assert len(got) > 100
    _check_grads(got, {k: want[k].numpy() for k in got})
    # The encoder's statistics moved twice (target, then reference), as in JAX.
    sd = model.state_dict()
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            err = np.abs(sd[name].numpy() - value.numpy()).max()
            assert err <= 1e-5 * max(1.0, float(np.abs(value.numpy()).max())), name


# -- optimizer -------------------------------------------------------------


def test_schedule_closed_form_matches_optax():
    sched = optax.cosine_decay_schedule(3e-4, 7, alpha=1e-6 / 3e-4)
    for count in range(10):
        assert cosine_decay(3e-4, 7, 1e-6 / 3e-4, count) == pytest.approx(
            float(sched(count)), rel=1e-6)


def test_adamw_and_schedule_match_optax_over_three_steps(rng):
    """DMSCTModule's AdamW and cosine schedule against JAX's make_optimizer
    (optax.adamw under multi_transform, the matcher set to zero), fed the
    same gradients for 3 steps; decay over 4 steps so the schedule moves."""
    jmod = JModule(**KW)
    params = {"matcher": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "encoder": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                          "b": rng.normal(size=(3,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-3, 1)).astype(np.float32),
        params) for _ in range(3)]
    tx = jmod.make_optimizer(num_train_steps=4)
    opt_state = tx.init(params)
    jparams = params
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    module = DMSCTModule(**KW)
    from color_transfer_tpu_torch.run.modules import TrainState

    variables = {"matcher.w": torch.tensor(params["matcher"]["w"]),
                 "encoder.w": torch.tensor(params["encoder"]["w"], requires_grad=True),
                 "encoder.b": torch.tensor(params["encoder"]["b"], requires_grad=True)}
    opt = torch.optim.AdamW([variables["encoder.w"], variables["encoder.b"]],
                            lr=module.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=module.weight_decay)
    state = TrainState(variables, opt, 0, 4)
    for g in grads:
        variables["encoder.w"].grad = torch.tensor(g["encoder"]["w"])
        variables["encoder.b"].grad = torch.tensor(g["encoder"]["b"])
        module.apply_gradients(state)
    assert state.step == 3
    for key in ("w", "b"):
        np.testing.assert_allclose(variables[f"encoder.{key}"].detach().numpy(),
                                   np.asarray(jparams["encoder"][key]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(variables["matcher.w"].numpy(), params["matcher"]["w"])
    np.testing.assert_array_equal(np.asarray(jparams["matcher"]["w"]), params["matcher"]["w"])


def test_init_state_freezes_the_matcher():
    module = DMSCTModule(**KW)
    state = module.init_state(0, {"gt": torch.zeros(1, 32, 48, 3)}, num_train_steps=5)
    opt_ids = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    params = dict(module.model.named_parameters())
    for name, value in state.variables.items():
        trainable = name in params and not name.startswith("matcher.")
        assert value.requires_grad == trainable, name
        assert (id(value) in opt_ids) == trainable, name
    assert state.decay_steps == 5 and state.step == 0
    group = state.optimizer.param_groups[0]
    assert group["weight_decay"] == 0.01 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8


def test_matcher_checkpoint_loads_into_init_state(tmp_path):
    """``matcher_checkpoint``: a port state_dict of the matcher (keys with or
    without the ``matcher.`` prefix) replaces the random matcher."""
    donor = DMSCTModule(**KW).init_state(7, {"gt": torch.zeros(1, 32, 48, 3)})
    matcher = {k[len("matcher."):]: v.detach() for k, v in donor.variables.items()
               if k.startswith("matcher.")}
    torch.save(matcher, tmp_path / "matcher.pt")
    module = DMSCTModule(**KW, matcher_checkpoint=str(tmp_path / "matcher.pt"))
    state = module.init_state(0, {"gt": torch.zeros(1, 32, 48, 3)})
    for name, value in matcher.items():
        assert torch.equal(state.variables[f"matcher.{name}"], value), name
    assert not torch.equal(state.variables["head.0.weight"], donor.variables["head.0.weight"])
