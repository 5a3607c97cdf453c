"""The DMSCT bf16 recipes through the port's harness: the module's three
knobs (the JAX module's ``matcher_corr_dtype``, ``matcher_compute_dtype``,
``corrector_compute_dtype``) built, served and trained; one train step of
the corrector in bf16 against the JAX package's, with one matcher output
fed to both sides (test_torch_port_train.py says why); the weights' f32
layout through the JAX converters; ``--model.matcher_compute_dtype
bfloat16`` through ``predict`` and ``fit`` (the files written with and
without it); the gate records and warnings (methods/gates.py); and
``parity_sweep --matcher_corr_dtype bfloat16``.

The train step is held by rule C3 (ROADMAP.md): in train mode BatchNorm
normalises with the batch's statistics, and at random init a bf16 rounding
that moves a channel's statistics moves the whole channel, so the
corrector's bf16 forward differs from its f32 forward by up to 14% at the
deepest level (JAX's own recipe; the port's bf16 from JAX's bf16 by 9%),
and a bf16 weight gradient's sign follows. So the port's bf16 step is held
to JAX's bf16 step as closely as JAX's f32 step is: each logged loss no
farther from JAX's bf16 loss than JAX's f32 loss is (measured: 0.66%
against 1.2%; the recipe's own distance under TRAIN_LOSS_RTOL); the share of
corrector parameters whose first AdamW update (about lr * sign(g)) has the
other sign, and the BatchNorm running statistics' largest distance, at
most FLIP_RATIO times JAX f32's (measured: 13.6% against 13.3%, 9.3e-3
against 8.4e-3 of scale); every update within 2 lr of JAX's; the matcher's
parameters bit for bit.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from color_transfer_tpu.run.modules import BNTrainState
from color_transfer_tpu.run.modules import DMSCTModule as JModule
from color_transfer_tpu.tools.convert_checkpoints import convert_dmsct
from color_transfer_tpu_torch.methods import gates
from color_transfer_tpu_torch.models import gmflow
from color_transfer_tpu_torch.run import cli
from color_transfer_tpu_torch.run.modules import DMSCTModule
from color_transfer_tpu_torch.tools import deep_gate
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

BF16 = {"matcher_corr_dtype": "bfloat16", "matcher_compute_dtype": "bfloat16",
        "corrector_compute_dtype": "bfloat16"}
TRAIN_LOSS_RTOL, FLIP_RATIO = 5e-2, 1.5
STEPS = 7


def _pair(rng, b=1, h=32, w=48):
    t = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    r = np.clip(np.roll(t, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    return torch.from_numpy(t), torch.from_numpy(r)


def test_module_builds_serves_and_trains_in_bf16():
    """The module with the three knobs: f32 variables, a finite served
    output in [0, 1], one train step that moves every corrector tensor and
    leaves the matcher bit-unchanged; the JAX module's hparams."""
    module = DMSCTModule(**KW, **BF16)
    assert module.model.matcher.compute_dtype == torch.bfloat16
    assert module.model.matcher.corr_dtype == torch.bfloat16
    assert module.model.encoder.dtype == torch.bfloat16
    jm = JModule(**KW, **BF16)
    assert {k: v for k, v in module.hparams.items() if k in jm.hparams} == jm.hparams
    rng = np.random.default_rng(0)
    t, r = _pair(rng, 2)
    variables = module.init_eval_variables(seed=0, device="cpu")
    assert all(v.dtype in (torch.float32, torch.long) for v in variables.values())
    out = module.eval_forward(variables, {"target": t, "reference": r})
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    state = module.init_state(0, {"gt": t, "reference": r}, num_train_steps=3)
    before = {k: v.detach().clone() for k, v in state.variables.items()}
    state, logs = module.train_step(state, {"gt": t, "reference": r}, seed=1, metrics=False)
    assert np.isfinite(float(logs["Training Total Loss"]))
    for name, value in state.variables.items():
        assert value.dtype == before[name].dtype
        if name.startswith("matcher."):
            assert torch.equal(value, before[name]), name
        elif name.endswith(("weight", "bias", "running_mean", "running_var")):
            assert not torch.equal(value, before[name]), name


def _jax_step(variables, batch, dtype="bfloat16"):
    jmod = JModule(**KW, heavy_metrics=False, corrector_compute_dtype=dtype)
    jmod.synthesize_targets = lambda b, key: {**b, "target": jnp.asarray(batch["target"])}
    state = BNTrainState.create(apply_fn=jmod.model.apply, params=variables["params"],
                                tx=jmod.make_optimizer(STEPS),
                                batch_stats=variables["batch_stats"])
    new, logs = jmod.train_step(state, {"gt": jnp.asarray(batch["gt"]),
                                        "reference": jnp.asarray(batch["reference"])},
                                jax.random.PRNGKey(0))
    return new, {k: float(v) for k, v in logs.items()}


def test_corrector_bf16_train_step_matches_jax(jax_variables, batch, jax_fed_dmsct):
    """One step of ``corrector_compute_dtype="bfloat16"`` from the same
    variables, targets and fed flow, against JAX's (rule C3: held to JAX's
    own bf16 step as closely as that is to JAX's f32 step)."""
    new_j, logs_j = _jax_step(jax_variables, batch)
    new_32, logs_32 = _jax_step(jax_variables, batch, None)
    module = DMSCTModule(**KW, heavy_metrics=False, corrector_compute_dtype="bfloat16")
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
    state, logs = module.train_step(state, t, seed=0)
    for name in ("Training Total Loss", "Training MSE Loss", "Training SSIM Loss"):
        recipe = abs(logs_32[name] - logs_j[name])
        assert abs(float(logs[name]) - logs_j[name]) <= recipe + 1e-6 * abs(logs_j[name]), name
        assert recipe <= TRAIN_LOSS_RTOL * abs(logs_j[name]), name
    after = {tag: _state_dict(jax.tree_util.tree_map(np.asarray, s.params),
                              jax.tree_util.tree_map(np.asarray, s.batch_stats))
             for tag, s in (("bf16", new_j), ("f32", new_32))}
    params = {name for name, _ in module.model.named_parameters()}
    lr = module.learning_rate
    flips = {"port": [0, 0], "recipe": [0, 0]}  # [updates whose sign differs, updates]
    stats = {"port": 0.0, "recipe": 0.0}
    for name, value in state.variables.items():
        got, want, f32 = (value.detach().numpy(), after["bf16"][name].numpy(),
                          after["f32"][name].numpy())
        p0 = before[name].numpy()
        if name.startswith("matcher."):
            assert torch.equal(value, before[name]), name
        elif name.endswith(("running_mean", "running_var")):
            scale = max(1.0, float(np.abs(want).max()))
            stats["port"] = max(stats["port"], float(np.abs(got - want).max()) / scale)
            stats["recipe"] = max(stats["recipe"], float(np.abs(f32 - want).max()) / scale)
        elif name in params:
            assert float(np.abs((got - p0) - (want - p0)).max()) <= 2.001 * lr, name
            for tag, other in (("port", got), ("recipe", f32)):
                flips[tag][0] += int((np.sign(other - p0) != np.sign(want - p0)).sum())
                flips[tag][1] += p0.size
    port, recipe = (flips[k][0] / flips[k][1] for k in ("port", "recipe"))
    assert port <= recipe * FLIP_RATIO, (port, recipe)
    assert stats["port"] <= stats["recipe"] * FLIP_RATIO, stats


def test_checkpoints_stay_f32_through_the_jax_converters(jax_variables):
    """The recipes change no parameter: the JAX tree carries into a bf16
    recipe's model strictly, every tensor f32, and back through the JAX
    package's convert_dmsct unchanged."""
    sd = _state_dict(jax_variables["params"], jax_variables["batch_stats"])
    module = DMSCTModule(**KW, **BF16)
    module.model.load_state_dict(sd, strict=True)
    out = {k: v.numpy() for k, v in module.model.state_dict().items()}
    assert all(v.dtype in (np.float32, np.int64) for v in out.values())
    params, stats = convert_dmsct(out)
    for tree, ref in ((params, jax_variables["params"]), (stats, jax_variables["batch_stats"])):
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        for path, value in jax.tree_util.tree_flatten_with_path(ref)[0]:
            np.testing.assert_array_equal(flat[path], value)


# -- the gate records and the serving surfaces --------------------------------------


@pytest.mark.parametrize("recipe", ["bf16", "bf16m", "bf16c", "bf16+fused", "bf16-nofuse",
                                    "bf16+refine32"])
def test_each_recipe_has_its_record(recipe):
    """A recipe's keywords key its own record, which holds the card's
    numbers (the worst dPSNR, dSSIM, diCID and pair PSNR)."""
    kw = deep_gate.recipe_kwargs("dmsct", recipe)
    assert gates.dmsct_recipe(kw) == recipe
    verdict, detail = gates.recipe_verdict("dmsct", kw)
    assert verdict in ("pass", "fail") and gates.RECORDS["dmsct", recipe][1] == detail
    for key in ("dPSNR", "dSSIM", "diCID", "pair PSNR", "H100"):
        assert key in detail, (key, detail)
    # torch dtypes key the same record as their names
    typed = {k: getattr(torch, v) if isinstance(v, str) and k.endswith("dtype") else v
             for k, v in kw.items()}
    assert gates.dmsct_recipe(typed) == recipe


def test_unrecorded_keywords():
    assert gates.dmsct_recipe({"matcher_corr_dtype": "bfloat16"}) is None
    assert gates.recipe_verdict("dmsct", {"matcher_corr_dtype": "bfloat16"})[0] == "unrecorded"
    assert gates.dmsct_recipe({"corrector_compute_dtype": "bfloat16",
                               "matcher_fused_attention": True}) is None
    assert gates.dmsct_recipe({}) == "f32"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for split, n in [("Train", 2), ("Validation", 1)]:
        (root / split).mkdir()
        for i in range(n):
            base = rng.integers(40, 215, (48, 64, 3), dtype=np.uint8)
            for view in ("L", "R"):
                Image.fromarray(base).save(root / split / f"{i:04d}_{view}.png")
    return root


@pytest.fixture
def bf16_calls(monkeypatch):
    """The dtypes the matcher's transformer is called with."""
    seen = []
    forward = gmflow.FeatureTransformer.forward

    def counted(self, f0, f1, splits):
        out = forward(self, f0, f1, splits)
        seen.append(out[0].dtype)
        return out

    monkeypatch.setattr(gmflow.FeatureTransformer, "forward", counted)
    return seen


def test_predict_takes_the_bf16_matcher(data_root, tmp_path, bf16_calls, monkeypatch):
    """``--model.matcher_compute_dtype bfloat16`` reaches the matcher through
    ``predict`` and changes the file written; a recipe whose record fails
    warns unless ``--allow_ungated``."""
    monkeypatch.setitem(gates.RECORDS, ("dmsct", "bf16m"), ("fail", "a test's record"))
    pair = [str(data_root / "Validation" / f"0000_{v}.png") for v in ("L", "R")]
    base = ["predict", "--method", "dmsct", "--target", pair[0], "--reference", pair[1],
            "--device", "cpu", "--model.matcher_num_layers", "1",
            "--model.matcher_num_reg_refine", "1"]
    assert cli.main(base + ["--output", str(tmp_path / "f32.png")]) == 0
    assert set(bf16_calls) == {torch.float32}
    bf16_calls.clear()
    recipe = ["--model.matcher_compute_dtype", "bfloat16", "--model.matcher_corr_dtype",
              "bfloat16"]
    with pytest.warns(UserWarning, match="FAILED its quality gate"):
        assert cli.main(base + recipe + ["--output", str(tmp_path / "bf16.png")]) == 0
    assert set(bf16_calls) == {torch.bfloat16}
    a, b = (np.asarray(Image.open(tmp_path / f)) for f in ("f32.png", "bf16.png"))
    assert a.shape == b.shape and not np.array_equal(a, b)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli.main(base + recipe + ["--output", str(tmp_path / "ack.png"),
                                         "--allow_ungated"]) == 0


def test_fit_takes_the_bf16_recipe(data_root, tmp_path, bf16_calls):
    """``fit`` with the recipe's knobs: the matcher runs in bf16, the
    checkpoint holds f32 variables unlike those of the f32 run, and its
    hparams carry ``corrector_compute_dtype`` as JAX's module's do."""
    def fit(log_dir, extra):
        return cli.main(["fit", "--config", "configs/dmsct.yaml", "--data.data_dir",
                         str(data_root), "--log_dir", str(log_dir), "--data.crop_size",
                         "[32, 48]", "--data.batch_size", "2", "--data.image_repeats", "1",
                         "--data.num_workers", "1", "--trainer.max_epochs", "1",
                         "--model.matcher_num_layers", "1",
                         "--model.matcher_num_reg_refine", "1",
                         "--model.heavy_metrics", "false", "--device", "cpu", *extra])

    assert fit(tmp_path / "f32", []) == 0
    assert set(bf16_calls) == {torch.float32}
    bf16_calls.clear()
    assert fit(tmp_path / "bf16", ["--model.matcher_compute_dtype", "bfloat16",
                                   "--model.corrector_compute_dtype", "bfloat16"]) == 0
    assert bf16_calls and set(bf16_calls) == {torch.bfloat16}
    meta = json.loads((tmp_path / "bf16" / "checkpoints" / "last" / "meta.json").read_text())
    assert meta["hparams"]["corrector_compute_dtype"] == "bfloat16"
    from color_transfer_tpu_torch.run.checkpoint import load_checkpoint

    (a, _), (b, _) = (load_checkpoint(tmp_path / d / "checkpoints" / "last")
                      for d in ("f32", "bf16"))
    va, vb = a["variables"], b["variables"]
    assert all(v.dtype == va[k].dtype for k, v in vb.items())
    assert any(not torch.equal(va[k], vb[k]) for k in va if k.startswith("encoder."))


def test_parity_sweep_takes_the_bf16_matcher(tmp_path, monkeypatch):
    """``--matcher_corr_dtype bfloat16`` reaches the DMSCT module built from
    the checkpoint, as in the JAX sweep."""
    from color_transfer_tpu_torch.tools import parity_sweep
    from test_cli import _make_data
    from test_parity_sweep import _save_dmsct_ckpt

    built = []
    module_for = parity_sweep.module_for

    def spy(kind, hparams, **kwargs):
        module = module_for(kind, hparams, **kwargs)
        built.append(module)
        return module

    monkeypatch.setattr(parity_sweep, "module_for", spy)
    root = _make_data(tmp_path / "data")
    dm = tmp_path / "dmsct.ckpt"
    _save_dmsct_ckpt(dm)
    rows = {}
    for dtype in ("float32", "bfloat16"):
        assert parity_sweep.main(["--data_dir", str(root), "--dmsct_ckpt", str(dm),
                                  "--no_classical", "--max_batches", "1", "--num_workers",
                                  "1", "--device", "cpu", "--matcher_corr_dtype", dtype,
                                  "--out", str(tmp_path / f"{dtype}.md")]) == 0
        rows[dtype] = (tmp_path / f"{dtype}.md").read_text()
    assert [m.model.matcher.corr_dtype for m in built] == [torch.float32, torch.bfloat16]
    assert "DMSCT" in rows["bfloat16"] and "nan" not in rows["bfloat16"]


def test_float64_reference_step_stays_float64():
    """The bf16 branches key on the reduced dtypes only: a float64 run of
    the corrector (the float64 reference of the card's step checks) stays
    float64 through BatchNorm, the SE mean and the residual, and lands
    within f32 rounding of the float32 step."""
    rng = torch.Generator().manual_seed(3)
    batch = {"gt": torch.rand(2, 32, 48, 3, generator=rng),
             "reference": torch.rand(2, 32, 48, 3, generator=rng)}
    target = (batch["gt"] ** 1.3 * 0.9 + 0.04).clamp(0, 1)
    fed = {"flow": torch.randn(2, 32, 48, 2, generator=rng) * 2.5,
           "fwd_occ": (torch.rand(2, 32, 48, 1, generator=rng) < 0.1).float()}
    losses = {}
    for dtype in (torch.float64, torch.float32):
        module = DMSCTModule(**KW, heavy_metrics=False)
        module.model.encoder.drop_connect_rate = 0.0
        on = {k: v.to(dtype) for k, v in fed.items()}
        module.model.matcher.forward = lambda *a, on=on, **k: on
        module.synthesize_targets = lambda b, gen, t=target.to(dtype): {**b, "target": t}
        b = {k: v.to(dtype) for k, v in batch.items()}
        state = module.init_state(0, b, num_train_steps=5)
        state.variables = {k: v.detach().to(dtype).requires_grad_(v.requires_grad)
                           if v.is_floating_point() else v for k, v in state.variables.items()}
        state.optimizer = torch.optim.AdamW(
            [v for v in state.variables.values() if v.requires_grad], lr=module.learning_rate)
        grads = []
        apply_gradients = module.apply_gradients

        def record(st, grads=grads, apply_gradients=apply_gradients):
            grads.extend(v.grad for v in st.variables.values() if v.grad is not None)
            apply_gradients(st)

        module.apply_gradients = record
        _, logs = module.train_step(state, b, seed=0, metrics=False)
        assert grads and all(g.dtype == dtype for g in grads)
        losses[dtype] = float(logs["Training Total Loss"])
    assert abs(losses[torch.float32] - losses[torch.float64]) <= 1e-5 * losses[torch.float64]
