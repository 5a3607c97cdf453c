"""Port parity: data parallelism over a device list
(color_transfer_tpu_torch/parallel/mesh.py, ``devices=`` of
methods/video.py and run/predict.py) against color_transfer_tpu's mesh
serving, and ``fit`` under torchrun on the CPU.

A device list may name one device twice, so the split runs here as
``["cpu", "cpu"]``: every frame must come out bit-equal to the one-device
call (the pieces are the one-device call's chunks). The classical output
is held to JAX's over its 8-device ``create_mesh()`` within the classical
parity line (test_torch_port_classical.py, atol 5e-5). ``fit`` runs as
``torchrun --nproc_per_node 2 ... fit --device cpu`` (gloo) on the tiny
DMSCT config: rank 0 alone writes one metrics line per log step and each
checkpoint once, and both ranks end with bit-equal variables.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu.methods.video import (
    color_transfer_between_videos as jax_videos,
)
from color_transfer_tpu.parallel import create_mesh as jax_mesh
from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
from color_transfer_tpu_torch.parallel import mesh
from color_transfer_tpu_torch.run.modules import DMSCTModule
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_port_harness import TINY, data_root  # noqa: F401  (a fixture)
from test_torch_port_multihost import LAUNCH_ENV, free_port

REPO = Path(__file__).resolve().parents[1]
CPU2 = ["cpu", "cpu"]


def _clip(t, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.05, 0.95, (t, h, w, 3)).astype(np.float32)
    reference = np.clip(target ** 1.2 * 0.9 + 0.05, 0, 1).astype(np.float32)
    return target, reference


# -- the device list ---------------------------------------------------------


def test_create_mesh_lists_devices():
    assert mesh.create_mesh(CPU2) == [torch.device("cpu")] * 2
    assert mesh.create_mesh([torch.device("cpu")]) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="empty"):
        mesh.create_mesh([])
    if not torch.cuda.is_available():
        for devices in (None, ["cuda"], ["cpu", "cuda:1"]):  # None: every visible card
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mesh.create_mesh(devices)


def test_shard_and_pad():
    x = torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2)
    padded, actual = mesh.pad_to_devices(x, 4)
    assert actual == 5 and padded.shape == (8, 2)
    assert torch.equal(padded[:5], x) and torch.equal(padded[5:], x[-1:].expand(3, 2))
    assert mesh.pad_to_devices(x, 5)[0] is x
    pieces = mesh.shard_batch({"x": padded, "y": padded + 1}, mesh.create_mesh(["cpu"] * 4))
    assert len(pieces) == 4
    assert torch.equal(torch.cat([p["x"] for p in pieces]), padded)
    assert all(p["y"].shape == (2, 2) for p in pieces)
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_batch({"x": x}, CPU2)


def test_replicate_copies_once():
    variables = {"w": torch.ones(3)}
    copies = mesh.replicate(variables, mesh.create_mesh(CPU2))
    assert copies[0] is copies[1]
    assert copies[0]["w"] is variables["w"]  # already on its device: no copy


# -- split serving -------------------------------------------------------------


@pytest.mark.parametrize("method", ["monge_kantorovitch", "automated_color_grading"])
@pytest.mark.parametrize("per_frame", [True, False], ids=["per_frame", "global"])
def test_classical_split_bit_equal(method, per_frame):
    target, reference = _clip(11)  # ragged: 8 a device -> one chunk of 11, padded to 16
    one = color_transfer_between_videos(target, reference, method=method, device="cpu",
                                        per_frame=per_frame)
    split = color_transfer_between_videos(target, reference, method=method, devices=CPU2,
                                          per_frame=per_frame)
    three = color_transfer_between_videos(target, reference, method=method,
                                          devices=["cpu"] * 3, batch_size=4,
                                          per_frame=per_frame)  # cut to 3 a chunk
    assert one.shape == split.shape == three.shape == (11, 24, 32, 3)
    assert torch.equal(one, split) and torch.equal(one, three)


def test_classical_split_matches_jax_mesh():
    target, reference = _clip(11, seed=1)
    want = np.asarray(jax_videos(jnp.asarray(target), jnp.asarray(reference),
                                 method="monge_kantorovitch", mesh=jax_mesh()))
    got = color_transfer_between_videos(target, reference, method="monge_kantorovitch",
                                        devices=CPU2)
    assert want.shape == tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_dmsct_split_bit_equal():
    module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1)
    variables = module.init_eval_variables(seed=0, device="cpu")
    target, reference = _clip(3, h=32, w=48, seed=2)  # one frame a device, ragged
    one = color_transfer_between_videos(target, reference, method="dmsct", module=module,
                                        variables=variables)
    split = color_transfer_between_videos(target, reference, method="dmsct", module=module,
                                          variables=variables, devices=CPU2)
    assert one.shape == (3, 32, 48, 3) and torch.equal(one, split)


def test_predict_pairs_over_devices(tmp_path):
    from PIL import Image

    from color_transfer_tpu_torch.run.predict import collect_pairs, predict_pairs

    target, reference = _clip(3, seed=3)
    for i in range(3):
        for view, img in (("L", target[i]), ("R", reference[i])):
            Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(
                tmp_path / f"{i:04d}_{view}.png")
    pairs = collect_pairs(tmp_path)
    a = predict_pairs(pairs, tmp_path / "one", method="reinhard", device="cpu")
    b = predict_pairs(pairs, tmp_path / "two", method="reinhard", devices=CPU2)
    assert [p.name for p in a] == [p.name for p in b] == [f"{i:04d}_C.png" for i in range(3)]
    for pa, pb in zip(a, b):
        assert np.array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))


# -- fit under torchrun --------------------------------------------------------

# Each rank runs the CLI and saves its final variables beside the log.
_RANK_FIT = """
import os, sys, torch
from color_transfer_tpu_torch.run import cli, trainer

fit = trainer.Trainer.fit

def keep(self, *args, **kwargs):
    state = fit(self, *args, **kwargs)
    torch.save({k: v.detach() for k, v in state.variables.items()},
               os.path.join(os.environ["RANK_OUT"], f"rank{self.rank}.pt"))
    return state

trainer.Trainer.fit = keep
torch.set_num_threads(2)
sys.exit(cli.main(sys.argv[1:]))
"""


def test_fit_under_torchrun_two_ranks(data_root, tmp_path):  # noqa: F811
    script = tmp_path / "rank_fit.py"
    script.write_text(_RANK_FIT)
    log_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(REPO), RANK_OUT=str(tmp_path), OMP_NUM_THREADS="2")
    tiny = [a if a != "2" or TINY[i - 1] != "--data.batch_size" else "4"
            for i, a in enumerate(TINY)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()), str(script),
           "fit", "--config", "configs/dmsct.yaml", "--data.data_dir", str(data_root),
           "--log_dir", str(log_dir), "--trainer.max_epochs", "2", *tiny]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=300)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:]
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in records if "Training Total Loss" in r]
    assert steps == [0, 1]  # 4 pairs, a global batch of 4: one step an epoch, logged once
    assert sum("Validation PSNR/dataloader_idx_0" in r for r in records) == 2
    for which in ("last", "best"):
        meta = json.loads((log_dir / "checkpoints" / which / "meta.json").read_text())
        assert meta["step"] in (1, 2)
    assert sorted(p.name for p in (log_dir / "checkpoints").iterdir()) == [
        "best", "best_score.json", "last"]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert all(torch.equal(v, ranks[1][k]) for k, v in ranks[0].items())
    last = torch.load(log_dir / "checkpoints" / "last" / "state.pt")["variables"]
    assert all(torch.equal(v, ranks[0][k]) for k, v in last.items())
