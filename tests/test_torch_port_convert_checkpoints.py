"""Port parity: the checkpoint readers (color_transfer_tpu_torch/tools/
convert_checkpoints.py, convert_gmflow.py) and ``matcher_checkpoint``'s
three formats against the JAX package's converters.

Reference-layout state_dicts are fabricated as the JAX package's tests
fabricate them: the smp efficientnet-b2 encoder of
tests/test_convert_checkpoints.py (all 23 blocks: the reader drops those
past DMSCT's taps), the UNet decoder and head with smp's (2C+1) skip plan,
and the GMFlow matcher through ``convert_gmflow.invert_to_state_dict`` of
test_torch_port_dmsct.py's weight-like JAX tree (plus unimatch's upsampler,
which the flow model does not use); DCMCS3DI through
tests/test_parity_sweep.py's fabricator. Each is read strictly into the
port's model, and the port's forward is held to JAX's on
``convert_dmsct`` / ``convert_dcmcs3di`` of the same dict at the model
parity tests' lines: DMSCT end to end atol 1e-3 (test_torch_port_dmsct.py),
DCMCS3DI 1e-4 of max(1, max|ref|) (test_torch_port_dcmcs3di.py).
"""

import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.models.dmsct import DMSCT as JDMSCT
from color_transfer_tpu.tools import convert_checkpoints as jcc
from color_transfer_tpu.tools.convert_gmflow import invert_to_state_dict
from color_transfer_tpu_torch.models.dcmcs3di import DCMCS3DI
from color_transfer_tpu_torch.models.dmsct import DMSCT
from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables
from color_transfer_tpu_torch.run.modules import DMSCTModule
from color_transfer_tpu_torch.tools import convert_checkpoints as cc
from color_transfer_tpu_torch.tools import convert_gmflow as cg
from color_transfer_tpu_torch.tools.convert import dmsct_state_dict_from_jax
from test_convert_checkpoints import _fabricate_smp_b2_state_dict
from test_parity_sweep import _save_dcmcs3di_ckpt
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dmsct import KW, jax_variables  # noqa: F401  (a fixture)

H, W = 30, 50
DC = dict(extraction_layers=2, transfer_layers=1, channels=8)
UPSAMPLER = {"upsampler.0.weight": (256, 130, 3, 3), "upsampler.0.bias": (256,),
             "upsampler.2.weight": (144, 256, 1, 1), "upsampler.2.bias": (144,)}


def _matcher_sd(jax_variables):
    return invert_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jax_variables["params"]["matcher"]))


def _reference_dmsct_sd(jax_variables):
    """A reference Lightning DMSCT state_dict (numpy): smp encoder with all
    23 b2 blocks, decoder and head, the matcher and unimatch's upsampler."""
    rs = np.random.default_rng(4)
    sd = _fabricate_smp_b2_state_dict(n_blocks=23)
    plan = [(241 + 97, 256), (256 + 49, 128), (128 + 65, 64), (64 + 7, 32)]
    for i, (cin, cout) in enumerate(plan):
        for conv, ci in (("conv1", cin), ("conv2", cout)):
            sd[f"decoder.blocks.{i}.{conv}.0.weight"] = rs.normal(
                scale=0.05, size=(cout, ci, 3, 3)).astype(np.float32)
            sd[f"decoder.blocks.{i}.{conv}.0.bias"] = rs.normal(
                scale=0.01, size=cout).astype(np.float32)
    sd["head.0.weight"] = rs.normal(scale=0.05, size=(3, 32, 3, 3)).astype(np.float32)
    sd["head.0.bias"] = np.zeros(3, dtype=np.float32)
    sd.update({f"matcher.{k}": v for k, v in _matcher_sd(jax_variables).items()})
    sd.update({f"matcher.{k}": rs.normal(size=s).astype(np.float32)
               for k, s in UPSAMPLER.items()})
    return sd


@pytest.fixture(scope="module")
def dmsct_ckpt(tmp_path_factory, jax_variables):
    sd = _reference_dmsct_sd(jax_variables)
    path = tmp_path_factory.mktemp("ckpt") / "epoch=72-step=7665.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": {"matcher_num_layers": 1, "matcher_num_reg_refine": 1,
                                     "learning_rate": 3e-4}}, path)
    return path, sd


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    r = np.clip(np.roll(t, 2, axis=2) * 0.85 + 0.08, 0, 1).astype(np.float32)
    return t, r


def test_dmsct_reference_ckpt_reads_strictly(dmsct_ckpt):
    path, sd = dmsct_ckpt
    ckpt = cc.load_reference_ckpt(path)
    assert ckpt.kind == "dmsct"
    assert ckpt.hparams == {**cc.HPARAMS["dmsct"], "matcher_num_layers": 1,
                            "matcher_num_reg_refine": 1}
    model = DMSCT(**KW)
    model.load_state_dict(ckpt.state_dict, strict=True)
    for k, v in ckpt.state_dict.items():
        if k in sd:
            np.testing.assert_array_equal(v.numpy(), sd[k])
        else:  # smp's count, absent from the file
            assert k.endswith("num_batches_tracked") and int(v) == 0
    # Dropped: the encoder's blocks past the taps and unimatch's upsampler.
    assert set(ckpt.dropped) == {k for k in sd if k.startswith("encoder._blocks.")
                                 and int(k.split(".")[2]) >= 16} | {
        f"matcher.{k}" for k in UPSAMPLER}


def test_dmsct_forward_matches_jax_on_the_same_dict(dmsct_ckpt, pair):
    path, sd = dmsct_ckpt
    params, batch_stats = jcc.convert_dmsct(sd)
    t, r = pair
    want = jax.jit(JDMSCT(**KW).apply)({"params": params, "batch_stats": batch_stats},
                                       jnp.asarray(t), jnp.asarray(r))
    model = DMSCT(**KW).eval()
    model.load_state_dict(cc.load_reference_ckpt(path).state_dict, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(t), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_batchnorm_counts_read_from_the_file(tmp_path, dmsct_ckpt):
    """A Lightning file carries BatchNorm's ``num_batches_tracked``: read as
    long tensors, the rest float32."""
    _, sd = dmsct_ckpt
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    counts = [k[: -len("running_mean")] + "num_batches_tracked" for k in sd
              if k.endswith("running_mean")]
    state.update({k: torch.tensor(7 + i) for i, k in enumerate(counts)})
    path = tmp_path / "with_counts.ckpt"
    torch.save({"state_dict": state, "hyper_parameters": {"matcher_num_layers": 1,
                                                          "matcher_num_reg_refine": 1}}, path)
    ckpt = cc.load_reference_ckpt(path)
    read = [k for k in counts if k in ckpt.state_dict]
    assert read and all(ckpt.state_dict[k].dtype == torch.long for k in read)
    assert int(ckpt.state_dict[read[0]]) == 7 + counts.index(read[0])
    assert all(v.dtype == torch.float32 for k, v in ckpt.state_dict.items()
               if not k.endswith("num_batches_tracked"))
    DMSCT(**KW).load_state_dict(ckpt.state_dict, strict=True)


def test_dcmcs3di_reference_ckpt_matches_jax(tmp_path, pair):
    path = tmp_path / "epoch=96-step=10185.ckpt"
    _save_dcmcs3di_ckpt(path, **DC)
    ckpt = cc.load_reference_ckpt(path)
    assert ckpt.kind == "dcmcs3di" and ckpt.hparams == DC and ckpt.dropped == []
    sd = {k: v.numpy() for k, v in torch.load(path)["state_dict"].items()}
    params = jcc.convert_dcmcs3di(sd, extraction_layers=2, transfer_layers=1)
    t, r = pair
    want, _ = jdc.DCMCS3DI(**DC).apply({"params": params}, jnp.asarray(t), jnp.asarray(r),
                                       inference=True)
    model = DCMCS3DI(**DC).eval()
    model.load_state_dict(ckpt.state_dict, strict=True)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(t), torch.from_numpy(r), inference=True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_unknown_or_missing_reference_key_raises(tmp_path, dmsct_ckpt):
    _, sd = dmsct_ckpt
    hp = {"matcher_num_layers": 1, "matcher_num_reg_refine": 1}
    for name, bad in (("unknown", {**sd, "decoder.blocks.9.conv1.0.weight": sd["head.0.bias"]}),
                      ("missing", {k: v for k, v in sd.items() if k != "head.0.weight"}),
                      ("layer", {**sd, "matcher.transformer.layers.1.self_attn.q_proj.weight":
                                 sd["matcher.transformer.layers.0.self_attn.q_proj.weight"]})):
        path = tmp_path / f"{name}.ckpt"
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in bad.items()},
                    "hyper_parameters": hp}, path)
        with pytest.raises(KeyError):
            cc.load_reference_ckpt(path)
    path = tmp_path / "shape.ckpt"
    torch.save({"state_dict": {**{k: torch.from_numpy(v) for k, v in sd.items()},
                               "head.0.bias": torch.zeros(4)}, "hyper_parameters": hp}, path)
    with pytest.raises(ValueError):
        cc.load_reference_ckpt(path)


def test_cli_writes_a_checkpoint_the_port_restores(tmp_path, dmsct_ckpt):
    path, _ = dmsct_ckpt
    out = tmp_path / "dmsct_port"
    assert cc.main(["--kind", "dmsct", "--torch_ckpt", str(path), "--out", str(out)]) == 0
    meta = json.loads((out / "meta.json").read_text())
    assert meta["hparams"]["matcher_num_layers"] == 1 and meta["step"] == 0
    variables = restore_eval_variables(DMSCTModule(**KW), out, device="cpu")
    want = cc.load_reference_ckpt(path).state_dict
    assert set(variables) == set(want)
    assert all(torch.equal(variables[k], want[k]) for k in want)


def test_unimatch_pth_keeps_the_flow_keys(tmp_path, jax_variables):
    """unimatch's .pth layout (``{"model": ...}`` with heads the flow model
    does not use) and the bare state_dict JAX's ``ckpt.get("model", ckpt)``
    also reads."""
    msd = _matcher_sd(jax_variables)
    rs = np.random.default_rng(1)
    full = {**{k: torch.from_numpy(v) for k, v in msd.items()},
            **{k: torch.from_numpy(rs.normal(size=s).astype(np.float32))
               for k, s in UPSAMPLER.items()}}
    torch.save({"model": full, "optimizer": {}, "step": 100}, tmp_path / "gmflow.pth")
    got = cg.load_matcher(tmp_path / "gmflow.pth")
    assert set(got) == set(msd)
    for k, v in msd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    torch.save(full, tmp_path / "bare.pth")
    assert set(cg.load_unimatch(tmp_path / "bare.pth")) == set(msd)
    out = tmp_path / "gmflow_port.pt"
    assert cg.main(["--torch_ckpt", str(tmp_path / "gmflow.pth"), "--out", str(out)]) == 0
    assert set(torch.load(out)) == set(msd)


def _matcher_of(state):
    return {k[len("matcher."):]: v for k, v in state.variables.items()
            if k.startswith("matcher.")}


@pytest.mark.parametrize("fmt", ["port", "port_prefixed", "unimatch", "jax_pickle"])
def test_init_state_reads_every_matcher_format(tmp_path, jax_variables, fmt):
    """``matcher_checkpoint``: a port state_dict (with or without the
    prefix), unimatch's .pth and the JAX converter's pickle all give the
    bridged JAX matcher."""
    want = {k[len("matcher."):]: v for k, v in dmsct_state_dict_from_jax(
        jax_variables["params"], jax_variables["batch_stats"]).items()
        if k.startswith("matcher.")}
    path = tmp_path / "matcher"
    if fmt == "port":
        torch.save(want, path)
    elif fmt == "port_prefixed":
        torch.save({f"matcher.{k}": v for k, v in want.items()}, path)
    elif fmt == "unimatch":
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              _matcher_sd(jax_variables).items()}}, path)
    else:  # what color_transfer_tpu.tools.convert_gmflow writes
        with open(path, "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, jax_variables["params"]["matcher"]),
                        f)
    state = DMSCTModule(**KW, matcher_checkpoint=str(path)).init_state(
        0, {"gt": torch.zeros(1, 32, 48, 3)})
    got = _matcher_of(state)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fmt", ["port", "jax_pickle"])
def test_init_state_unknown_matcher_key_raises(tmp_path, jax_variables, fmt):
    path = tmp_path / "matcher"
    if fmt == "port":
        torch.save({"backbone.conv9.weight": torch.zeros(3)}, path)
    else:
        tree = jax.tree_util.tree_map(np.asarray, jax_variables["params"]["matcher"])
        tree["core"]["extra_head"] = {"kernel": np.zeros((3, 3, 4, 4), np.float32)}
        with open(path, "wb") as f:
            pickle.dump(tree, f)
    with pytest.raises(KeyError):
        DMSCTModule(**KW, matcher_checkpoint=str(path)).init_state(
            0, {"gt": torch.zeros(1, 32, 48, 3)})
