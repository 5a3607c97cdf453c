"""Port parity: one whole DMSCT train step
(color_transfer_tpu_torch/run/modules.py::DMSCTModule.train_step) against
color_transfer_tpu's ``DMSCTModule.train_step``, from the same variables on
the same batch and targets, with drop-connect off and one matcher output
fed to both sides (test_torch_port_train.py says why).

Lines: the logged losses 1e-5 relative; BatchNorm running statistics after
the step 1e-5 of max(1, max|ref|); each trainable parameter's update. The
first AdamW update is lr * (g / (|g| + eps) + wd * p), about lr * sign(g):
where |g| is at least 1e-2 of its tensor's largest gradient and of the
model's largest (far above the gradient line of test_torch_port_train.py,
which floors each tensor's scale there too) the updates agree within
2e-7 of max(1, max|p|), the f32 rounding of p; elsewhere a sign may differ
and they agree within 2 lr. The matcher's parameters stay bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.run.modules import BNTrainState
from color_transfer_tpu_torch.run.modules import DMSCTModule
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_train import (  # noqa: F401  (jax_fed_dmsct is a fixture)
    FED,
    KW,
    _state_dict,
    batch,
    feed_matcher,
    jax_fed_dmsct,
    jax_variables,
)

STEPS = 7  # the schedule's length


def _jax_step(variables, batch, target):
    from color_transfer_tpu.run.modules import DMSCTModule as JModule

    jmod = JModule(**KW, heavy_metrics=False)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(target)}
    state = BNTrainState.create(apply_fn=jmod.model.apply, params=variables["params"],
                                tx=jmod.make_optimizer(STEPS),
                                batch_stats=variables["batch_stats"])
    new, logs = jmod.train_step(state, {"gt": jnp.asarray(batch["gt"]),
                                        "reference": jnp.asarray(batch["reference"])},
                                jax.random.PRNGKey(0))
    return new, {k: float(v) for k, v in logs.items()}


@pytest.fixture
def stepped(jax_variables, batch, jax_fed_dmsct):
    """(port module, variables before, state after, logs, the port's
    gradient, JAX's new state and logs)."""
    new_j, logs_j = _jax_step(jax_variables, batch, batch["target"])

    module = DMSCTModule(**KW, heavy_metrics=False)
    module.model.encoder.drop_connect_rate = 0.0
    feed_matcher(module.model, FED)
    target = torch.from_numpy(batch["target"])
    module.synthesize_targets = lambda b, gen: {**b, "target": target}
    t = {k: torch.from_numpy(batch[k]) for k in ("gt", "reference")}
    state = module.init_state(0, t, num_train_steps=STEPS)
    sd = _state_dict(jax_variables["params"], jax_variables["batch_stats"])
    with torch.no_grad():
        for k, v in sd.items():
            state.variables[k].copy_(v)
    before = {k: v.detach().clone() for k, v in state.variables.items()}
    grads = {}
    apply_gradients = module.apply_gradients

    def record(st):
        grads.update({k: v.grad.clone() for k, v in st.variables.items()
                      if v.grad is not None})
        apply_gradients(st)

    module.apply_gradients = record
    state, logs = module.train_step(state, t, seed=0)
    return module, before, state, logs, grads, new_j, logs_j


def test_train_step_matches_jax(stepped):
    module, before, state, logs, grads, new_j, logs_j = stepped
    assert state.step == 1 and int(new_j.step) == 1
    assert sorted(logs) == sorted(logs_j)
    for name in ("Training Total Loss", "Training MSE Loss", "Training SSIM Loss"):
        assert abs(float(logs[name]) - logs_j[name]) <= 1e-5 * abs(logs_j[name]), name
    after_j = _state_dict(jax.tree_util.tree_map(np.asarray, new_j.params),
                          jax.tree_util.tree_map(np.asarray, new_j.batch_stats))
    params = {name for name, _ in module.model.named_parameters()}
    lr = module.learning_rate
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    checked = 0
    for name, value in state.variables.items():
        got = value.detach().numpy()
        want = after_j[name].numpy()
        if name.startswith("matcher."):
            assert torch.equal(value, before[name]), name  # bit for bit
        elif name.endswith(("running_mean", "running_var")):
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, name
        elif name in params:
            g = np.abs(grads[name].numpy())
            p0 = before[name].numpy()
            err = np.abs((got - p0) - (want - p0))
            clear = g >= max(1e-2 * g.max(), floor)
            line = 2e-7 * max(1.0, float(np.abs(p0).max()))
            assert float(err[clear].max(initial=0.0)) <= line, name
            assert float(err.max()) <= 2 * lr + 1e-8, name
            checked += 1
    assert checked > 100


def test_train_step_logs_and_generators():
    """The logs carry the JAX package's names; the metrics only when asked;
    the same seed gives the same targets."""
    module = DMSCTModule(**KW)
    rng = np.random.default_rng(1)
    b = {"gt": torch.from_numpy(rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)),
         "reference": torch.from_numpy(rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32))}
    state = module.init_state(0, b, num_train_steps=3)
    _, logs = module.train_step(state, b, seed=3, metrics=True)
    assert sorted(logs) == sorted(["Training MSE Loss", "Training SSIM Loss",
                                   "Training Total Loss", "Training PSNR", "Training SSIM",
                                   "Training iCID", "Training FSIM"])
    assert all(np.isfinite(float(v)) for v in logs.values())
    _, logs = module.train_step(state, b, seed=4, metrics=False)
    assert sorted(logs) == ["Training MSE Loss", "Training SSIM Loss", "Training Total Loss"]
    assert state.step == 2
    a = module.synthesize_targets(b, torch.Generator().manual_seed(7))["target"]
    c = module.synthesize_targets(b, torch.Generator().manual_seed(7))["target"]
    assert torch.equal(a, c) and not torch.equal(a, b["gt"])
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
