"""Port parity: bucketed evaluation (color_transfer_tpu_torch/run/bucketing.py)
and the ``valid_hw`` argument of FSIM and iCID against color_transfer_tpu.

Lines: ``snap_shape`` and ``pad_batch`` exact; masked PSNR rtol 1e-6, the
other masked metrics rtol 1e-5 (f32 on both sides); the bucketed evaluator
on bridged DCMCS3DI weights (test_torch_port_dcmcs3di.py's) within 1e-4 of
JAX's, output and metrics; bucketed against native evaluation on JAX's own
line (tests/test_bucketing.py): the output within 1e-4 outside a 16-pixel
band at the padded border, PSNR within 0.5 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu import metrics as JM
from color_transfer_tpu.run import bucketing as JB
from color_transfer_tpu.run.modules import DCMCS3DIModule as JModule
from color_transfer_tpu_torch import metrics as M
from color_transfer_tpu_torch.run import bucketing as B
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule
from color_transfer_tpu_torch.run.trainer import Trainer
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_dcmcs3di import C, EXT, TRA, params, state_dict  # noqa: F401

KW = dict(extraction_layers=EXT, transfer_layers=TRA, channels=C)


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    out = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    return out, gt


def _padded(x, bucket):
    h, w = x.shape[1:3]
    return np.pad(x, ((0, 0), (0, bucket[0] - h), (0, bucket[1] - w), (0, 0)))


@pytest.mark.parametrize("hw,multiple", [((100, 130), 64), ((64, 128), 64), ((33, 50), 32)])
def test_snap_shape_and_pad_batch(hw, multiple):
    bucket = B.snap_shape(*hw, multiple)
    assert bucket == JB.snap_shape(*hw, multiple)
    rng = np.random.default_rng(1)
    batch = {k: rng.uniform(size=(2, *hw, 3)).astype(np.float32) for k in ("gt", "target")}
    got, true_hw = B.pad_batch({k: torch.from_numpy(v) for k, v in batch.items()}, bucket)
    want, jtrue = JB.pad_batch({k: jnp.asarray(v) for k, v in batch.items()}, bucket)
    assert true_hw == tuple(jtrue) == hw and "reference" not in got
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# (true shape, bucket): FSIM, iCID and SSIM downsample by 1 at the first two
# buckets and by 2 at the last.
SHAPES = [((40, 56), (64, 64)), ((96, 128), (128, 192)), ((390, 420), (448, 448))]


@pytest.mark.parametrize("hw,bucket", SHAPES)
def test_masked_metrics_match_jax(hw, bucket):
    out, gt = (_padded(x, bucket) for x in _pair(*hw, seed=2))
    got = B.masked_quality_metrics(torch.from_numpy(out), torch.from_numpy(gt), *hw)
    want = JB.masked_quality_metrics(jnp.asarray(out), jnp.asarray(gt), jnp.int32(hw[0]),
                                     jnp.int32(hw[1]))
    assert set(got) == set(want) == {"PSNR", "SSIM", "iCID", "FSIM"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6 if k == "PSNR" else 1e-5, err_msg=k)


@pytest.mark.parametrize("hw,bucket", SHAPES[:2])
def test_masked_psnr_and_ssim_equal_native(hw, bucket):
    out, gt = _pair(*hw, seed=3)
    po, pg = (torch.from_numpy(_padded(x, bucket)) for x in (out, gt))
    native = (float(M.psnr(torch.from_numpy(out), torch.from_numpy(gt))),
              float(M.ssim(torch.from_numpy(out), torch.from_numpy(gt))))
    np.testing.assert_allclose(float(B.masked_psnr(po, pg, *hw)), native[0], rtol=1e-6)
    np.testing.assert_allclose(float(B.masked_ssim(po, pg, *hw)), native[1], rtol=1e-5)


@pytest.mark.parametrize("hw,bucket", [SHAPES[0], SHAPES[2]])
def test_valid_hw_fsim_icid_match_jax(hw, bucket):
    out, gt = (_padded(x, bucket) for x in _pair(*hw, seed=4))
    for port, ref in ((M.fsim, JM.fsim), (M.icid, JM.icid)):
        got = float(port(torch.from_numpy(out), torch.from_numpy(gt), valid_hw=hw))
        want = float(ref(jnp.asarray(out), jnp.asarray(gt),
                         valid_hw=(jnp.int32(hw[0]), jnp.int32(hw[1]))))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _batch(h, w, seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    return {"gt": gt, "target": np.clip(gt * 1.15, 0, 1).astype(np.float32),
            "reference": rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)}


@pytest.mark.parametrize("hw,multiple", [((40, 56), 32), ((33, 50), 16)])
def test_bucketed_evaluator_matches_jax(params, state_dict, hw, multiple):
    batch = _batch(*hw, seed=5)
    jout, jlogs = JB.BucketedEvaluator(JModule(**KW), multiple=multiple).eval_batch(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    out, logs = B.BucketedEvaluator(DCMCS3DIModule(**KW), multiple=multiple).eval_batch(
        state_dict, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == (1, *hw, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4, rtol=0)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), atol=1e-4, rtol=0,
                                   err_msg=k)


def test_bucketed_close_to_native():
    """JAX's own case (tests/test_bucketing.py): its module's size, its
    seed-0 init (bridged), its batch."""
    kw = dict(extraction_layers=2, transfer_layers=1, channels=8)
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (1, 40, 56, 3)).astype(np.float32)
    batch = {"gt": gt, "target": np.clip(gt * 1.15, 0, 1),
             "reference": rng.uniform(0, 1, (1, 40, 56, 3)).astype(np.float32)}
    jstate = JModule(**kw).init_state(jax.random.PRNGKey(0),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    variables = dcmcs3di_state_dict_from_jax(jstate.params)
    module = DCMCS3DIModule(**kw, heavy_metrics=False)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    native = module.eval_forward(variables, batch)
    out, logs = B.BucketedEvaluator(module, multiple=32).eval_batch(variables, batch)
    band = 16
    np.testing.assert_allclose(out[:, :-band, :-band].numpy(),
                               native[:, :-band, :-band].numpy(), atol=1e-4)
    assert abs(float(logs["PSNR"]) - float(M.psnr(native, batch["gt"]))) < 0.5


class _Loaders:
    def __init__(self, batches):
        self.batches = batches

    def test_loaders(self):
        return [self.batches]


def test_trainer_test_buckets_only_valid_w_modules(state_dict, tmp_path):
    """Trainer.test(eval_buckets=) pads for DCMCS3DI (the true width reaches
    the model: the masked metrics equal the evaluator's) and warns for a
    module that cannot mask, then runs it at native shapes."""
    batch = {k: (v * 255).astype(np.uint8) for k, v in _batch(40, 56, seed=6).items()}
    trainer = Trainer(log_dir=tmp_path, device="cpu")
    module = DCMCS3DIModule(**KW)
    got = trainer.test(module, _Loaders([batch]), variables=state_dict, eval_buckets=32)
    fb = {k: torch.from_numpy(v.astype(np.float32) / 255.0) for k, v in batch.items()}
    _, want = B.BucketedEvaluator(module, multiple=32).eval_batch(state_dict, fb)
    for k, v in want.items():
        assert got[f"Test {k}/dataloader_idx_0"] == pytest.approx(float(v), rel=1e-6)
    dmsct = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1)
    with pytest.warns(UserWarning, match="--eval_buckets ignored: module 'dmsct'"):
        trainer.test(dmsct, _Loaders([]), eval_buckets=32)
