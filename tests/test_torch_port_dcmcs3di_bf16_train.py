"""Port parity: DCMCS3DI's bf16 training recipe (``DCMCS3DIModule(
compute_dtype="bfloat16").train_step``: the extraction and transfer convs in
bf16, the parameters, the matcher and the losses in f32) against
color_transfer_tpu's, on the weights of test_torch_port_dcmcs3di.py (8
channels, 3 extraction and 2 transfer ResB blocks, 16 x 40 images), the
target passed in to both sides.

By the bf16 rule (ROADMAP.md, section C):
  * each bf16 stage's backward (the extraction and the transfer stacks),
    JAX's forward input and one cotangent fed to both, in bf16 ulps of the
    gradient's magnitude (2^(floor(log2 max|ref|) - 7)): the input's and
    every conv weight's gradient within STAGE_GRAD_ULPS (measured: 0.25),
    every bias's within BIAS_GRAD_ULPS (measured: 10.5). torch's and XLA's
    CPU bf16 convs sum in other orders, so a bf16 rounding of an output
    gradient flips by an ulp now and then; a bias's gradient sums those
    over every pixel (1280 here) and cancels to well under their magnitude,
    so its flips count for more of it. The forward stages are held in
    test_torch_port_dcmcs3di.py (s / 32);
  * the whole step by rule C3, recipe against recipe on shared weights:
    each logged value no farther from JAX's bf16 step than JAX's f32 step
    is (plus 1e-6 relative); the share of parameters whose first Adam
    update (about lr * sign(g)) takes the other sign than JAX bf16's, at
    most JAX f32's share (measured: 0.23% against 0.36%); every update
    within 2 lr of JAX bf16's; the parameters f32 and moved;
  * JAX's own checks (tests/test_round3_fixes.py:140-194): the bf16
    forward within 0.05 of f32 and not equal to it;
  * ``remat_convs``: bit-equal updates, with both matchers.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.training import train_state

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.run.modules import DCMCS3DIModule as JModule
from color_transfer_tpu_torch.models import dcmcs3di as tdc
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dcmcs3di import C, EXT, TRA, H, W, params, state_dict  # noqa: F401

KW = dict(extraction_layers=EXT, transfer_layers=TRA, channels=C)
STAGE_GRAD_ULPS, BIAS_GRAD_ULPS = 1, 16
LOG_RTOL = 1e-6
MATCHERS = [True, False]
MATCHER_IDS = ["chunked", "materialised"]


def _ulps(got, want):
    """max|got - want| in bf16 ulps of max|want|."""
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    return float(np.abs(got - want).max()) / ulp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    reference = np.clip(np.roll(gt, 3, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    target = np.clip(gt ** 1.2 * 0.9 + 0.04, 0, 1).astype(np.float32)
    return {"gt": gt, "target": target, "reference": reference}


# -- the bf16 stages' backward -------------------------------------------------


@pytest.mark.parametrize("stage", ["extraction", "transfer"])
def test_bf16_stage_gradients(params, state_dict, stage):
    rng = np.random.default_rng(3)
    c_in = 3 if stage == "extraction" else 2 * C + 1
    x = rng.uniform(0, 1, (2, H, W, c_in)).astype(np.float32)
    jmodel = jdc.DCMCS3DI(**KW, compute_dtype=jnp.bfloat16)

    def run(p, xx):
        return jmodel.apply({"params": p}, xx, method=lambda m, v: getattr(m, stage)(v))

    out, vjp = jax.vjp(run, params, jnp.asarray(x))
    ct = rng.standard_normal(out.shape).astype(np.float32)
    g_params, g_x = vjp(jnp.asarray(ct, out.dtype))
    g_params = dcmcs3di_state_dict_from_jax(g_params)

    model = tdc.DCMCS3DI(**KW, compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = getattr(model, stage)(xt)
    assert got.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    got.backward(torch.from_numpy(ct).to(torch.bfloat16))
    assert _ulps(xt.grad, g_x) <= STAGE_GRAD_ULPS
    for name, p in getattr(model, stage).named_parameters():
        assert p.grad.dtype == torch.float32
        line = BIAS_GRAD_ULPS if name.endswith("bias") else STAGE_GRAD_ULPS
        assert _ulps(p.grad, g_params[f"{stage}.{name}"]) <= line, name


# -- the whole step (C3) -------------------------------------------------------


def _jax_step(params, batch, dtype, fused):
    jmod = JModule(**KW, heavy_metrics=False, fused_attention=fused, attention_chunk=4,
                   compute_dtype=dtype)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(batch["target"])}
    state = train_state.TrainState.create(apply_fn=jmod.model.apply, params=params,
                                          tx=optax.adam(jmod.learning_rate))
    new, logs = jmod.train_step(state, {"gt": jnp.asarray(batch["gt"]),
                                        "reference": jnp.asarray(batch["reference"])},
                                jax.random.PRNGKey(0))
    return dcmcs3di_state_dict_from_jax(new.params), {k: float(v) for k, v in logs.items()}


def _port_step(state_dict, batch, fused, remat=False):
    module = DCMCS3DIModule(**KW, heavy_metrics=False, fused_attention=fused,
                            attention_chunk=4, compute_dtype="bfloat16", remat_convs=remat)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = module.init_state(0, b, num_train_steps=7)
    with torch.no_grad():
        for k, v in state.variables.items():
            v.copy_(state_dict[k])
    module.synthesize_targets = lambda bb, gen: {**bb, "target": b["target"]}
    state, logs = module.train_step(state, {"gt": b["gt"], "reference": b["reference"]},
                                    seed=0)
    assert state.step == 1
    return ({k: v.detach() for k, v in state.variables.items()},
            {k: float(v) for k, v in logs.items()})


def _flip_share(a, b, before, lr):
    """The share of parameters whose updates from ``before`` (each about
    lr * sign(g)) take opposite signs, both over lr / 2."""
    flips = total = 0
    for k, p0 in before.items():
        ua, ub = a[k] - p0, b[k] - p0
        big = (ua.abs() > lr / 2) & (ub.abs() > lr / 2)
        flips += int((big & (ua.sign() != ub.sign())).sum())
        total += p0.numel()
    return flips / total


@pytest.fixture(scope="module")
def jax_steps(params, batch):
    """JAX's f32 and bf16 steps with each matcher (their updates coincide:
    the two matchers give one loss)."""
    return {(dtype, fused): _jax_step(params, batch, dtype, fused)
            for dtype in (None, "bfloat16") for fused in MATCHERS}


@pytest.mark.parametrize("fused", MATCHERS, ids=MATCHER_IDS)
def test_bf16_step_matches_jax_by_c3(state_dict, batch, jax_steps, fused):
    got, logs = _port_step(state_dict, batch, fused)
    want, logs16 = jax_steps[("bfloat16", fused)]
    f32, logs32 = jax_steps[(None, fused)]
    assert set(logs) == set(logs16) and "Training Total Loss" in logs
    for k, v in logs16.items():
        assert np.isfinite(logs[k]), k
        assert abs(logs[k] - v) <= abs(logs32[k] - v) + LOG_RTOL * abs(v), (k, logs[k], v)
    lr = 1e-4
    assert _flip_share(got, want, state_dict, lr) <= _flip_share(f32, want, state_dict, lr)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert float((v - want[k]).abs().max()) <= 2 * lr + 1e-8, k
    assert all(not torch.equal(v, state_dict[k]) for k, v in got.items())


@pytest.mark.parametrize("fused", MATCHERS, ids=MATCHER_IDS)
def test_bf16_remat_is_bit_equal(state_dict, batch, fused):
    plain, logs = _port_step(state_dict, batch, fused)
    remat, logs_remat = _port_step(state_dict, batch, fused, remat=True)
    assert logs == logs_remat
    assert all(torch.equal(plain[k], remat[k]) for k in plain)


def test_bf16_forward_tracks_f32(state_dict, batch):
    """JAX's own check of the recipe: the bf16 forward within 0.05 of f32
    and not equal to it (the knob engages); the variables stay f32."""
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for dtype in (None, "bfloat16"):
        module = DCMCS3DIModule(**KW, heavy_metrics=False, compute_dtype=dtype)
        variables = module.init_eval_variables(0, device="cpu")
        assert all(v.dtype == torch.float32 for v in variables.values())
        outs.append(module.eval_forward(dict(state_dict), b))
    assert outs[1].dtype == torch.float32
    assert float((outs[0] - outs[1]).abs().max()) < 0.05
    assert not torch.equal(outs[0], outs[1])


def test_bf16_step_routes_its_convs(state_dict, batch, monkeypatch):
    """The bf16 convs take ``reduced_cudnn``'s route forward and backward
    (core/precision.py::routed_conv2d); the f32 convs of the matcher do
    not."""
    from color_transfer_tpu_torch.core import precision

    seen = []
    apply = precision._RoutedConv.apply

    def spy(x, weight, padding, cudnn):
        seen.append((x.dtype, cudnn))
        return apply(x, weight, padding, cudnn)

    monkeypatch.setattr(precision._RoutedConv, "apply", spy)
    module = DCMCS3DIModule(**KW, heavy_metrics=False, compute_dtype="bfloat16")
    module.reduced_cudnn = False
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = module.init_state(0, b)
    module.train_step(state, {"gt": b["gt"], "reference": b["reference"]}, seed=0,
                      metrics=False)
    # 1 stem + 2 x 3 ResB convs, 1 stem + 2 x 2 ResB + 2 tail convs.
    assert seen == [(torch.bfloat16, False)] * (1 + 2 * EXT + 1 + 2 * TRA + 2)


def test_fit_through_the_cli_in_bf16(tmp_path):
    """``fit --config configs/dcmcs3di.yaml --model.compute_dtype bfloat16``
    runs end to end: finite logged losses, the checkpoint's variables f32
    and unlike the f32 run's, the hparams naming the recipe."""
    from PIL import Image

    from color_transfer_tpu_torch.run.checkpoint import load_checkpoint

    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for split, n in [("Train", 2), ("Validation", 1)]:
        (data / split).mkdir(parents=True)
        for i in range(n):
            base = rng.integers(40, 215, (32, 48, 3), dtype=np.uint8)
            for view in ("L", "R"):
                Image.fromarray(base).save(data / split / f"{i:04d}_{view}.png")

    def fit(log_dir, extra):
        return cli.main(["fit", "--config", "configs/dcmcs3di.yaml", "--data.data_dir",
                         str(data), "--log_dir", str(log_dir), "--data.crop_size", "[16, 24]",
                         "--data.batch_size", "2", "--data.image_repeats", "1",
                         "--data.num_workers", "1", "--trainer.max_epochs", "1",
                         "--trainer.log_every", "1", "--model.extraction_layers", "1",
                         "--model.transfer_layers", "1", "--model.channels", "8",
                         "--model.heavy_metrics", "false", "--device", "cpu", *extra])

    assert fit(tmp_path / "f32", []) == 0
    assert fit(tmp_path / "bf16", ["--model.compute_dtype", "bfloat16"]) == 0
    lines = [json.loads(line) for line in
             (tmp_path / "bf16" / "metrics.jsonl").read_text().splitlines()]
    losses = [v for e in lines for k, v in e.items() if k == "Training Total Loss"]
    assert losses and all(np.isfinite(losses))
    meta = json.loads((tmp_path / "bf16" / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["hparams"]["compute_dtype"] == "bfloat16"
    (a, _), (b, _) = (load_checkpoint(tmp_path / d / "checkpoints" / "last")
                      for d in ("f32", "bf16"))
    va, vb = a["variables"], b["variables"]
    assert set(va) == set(vb) and all(v.dtype == torch.float32 for v in vb.values())
    assert any(not torch.equal(va[k], vb[k]) for k in va)
