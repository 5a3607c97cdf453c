"""The port's spans where the work happens (utils/profiling.py's names), on
the CPU: the tree a served DMSCT frame gives, both modules' train-step
phases, and the all-reduces of a two-rank gloo DMSCT step counted against
the number the model implies. The recorder changes no result: outputs and
losses are bit-identical with it on and off.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from color_transfer_tpu_torch.methods.video import build_deep, color_transfer_between_videos
from color_transfer_tpu_torch.models.efficientnet import _BN
from color_transfer_tpu_torch.parallel.data_parallel import gradient_buckets
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule
from color_transfer_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
REFINE = 2  # the served matcher's GRU refinements
PHASES = ["train.distort", "train.forward", "train.backward", "train.update", "train.logs"]


@pytest.fixture
def recorder():
    profiling.disable()
    profiling.clear()
    yield profiling
    profiling.disable()
    profiling.clear()


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def _frames(seed=0, n=1, h=64, w=96):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    reference = np.clip(np.roll(target, 3, axis=2) * 0.9 + 0.05, 0, 1).astype(np.float32)
    return target, reference


def test_served_frame_span_tree(recorder):
    module, variables = build_deep("dmsct", module_kwargs={
        "matcher_num_layers": 1, "matcher_num_reg_refine": REFINE}, device="cpu")
    target, reference = _frames()

    def serve():
        return color_transfer_between_videos(target, reference, method="dmsct", module=module,
                                             variables=variables, device="cpu")

    off = serve()
    profiling.enable()
    on = serve()
    profiling.disable()
    assert torch.equal(on, off)

    recs = profiling.records()
    (call,) = [r for r in recs if r.parent is None]
    assert call.name == "video.call" and isinstance(call.unit, int)
    assert all(r.unit == call.unit for r in recs)
    copy_in, forward = _children(recs, call)
    assert (copy_in.name, forward.name) == ("video.copy_in", "video.forward")
    matcher, correct = _children(recs, forward)
    assert (matcher.name, correct.name) == ("dmsct.matcher", "dmsct.correct")
    assert [r.name for r in _children(recs, matcher)] == (
        ["gmflow.backbone"] + ["gmflow.transformer", "gmflow.match"] * 2
        + ["gmflow.refine"] * REFINE)
    assert _children(recs, correct) == []
    assert len(recs) == 5 + 5 + REFINE


def _dmsct_module():
    return DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1, heavy_metrics=False)


def _dcmcs3di_module():
    return DCMCS3DIModule(extraction_layers=1, transfer_layers=1, channels=8,
                          heavy_metrics=False, attention_chunk=4)


@pytest.mark.parametrize("make,shape", [(_dmsct_module, (2, 32, 48)),
                                        (_dcmcs3di_module, (2, 16, 40))],
                         ids=["dmsct", "dcmcs3di"])
def test_train_step_phases(recorder, make, shape):
    target, reference = _frames(1, *shape)
    batch = {"gt": torch.from_numpy(target), "reference": torch.from_numpy(reference)}
    logs = {}
    for on in (False, True):
        module = make()
        state = module.init_state(0, batch)
        state.step = 4
        if on:
            profiling.enable()
        _, logs[on] = module.train_step(state, batch, seed=11, metrics=True)
        profiling.disable()
    assert logs[True].keys() == logs[False].keys()
    assert all(torch.equal(logs[True][k], logs[False][k]) for k in logs[False])

    recs = profiling.records()
    (step,) = [r for r in recs if r.parent is None]
    assert step.name == "train.step" and step.unit == 4
    assert all(r.unit == 4 for r in recs)
    phases = {r.name: r for r in _children(recs, step)}
    assert [r.name for r in _children(recs, step)] == PHASES
    inside = [r.name for r in _children(recs, phases["train.forward"])]
    if make is _dmsct_module:
        assert inside == ["dmsct.matcher", "dmsct.correct"]
    else:
        assert inside == ["dcmcs3di.extraction", "dcmcs3di.matcher"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = textwrap.dedent('''
    import sys

    import torch

    from color_transfer_tpu_torch.parallel import multihost
    from color_transfer_tpu_torch.run.modules import DMSCTModule
    from color_transfer_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    multihost.initialize_distributed(sys.argv[2], 2, rank, device="cpu", timeout=120)
    g = torch.Generator().manual_seed(3)
    gt = torch.rand(4, 32, 48, 3, generator=g)[2 * rank:2 * rank + 2]
    batch = {"gt": gt, "reference": gt.roll(3, dims=2)}
    module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1, heavy_metrics=False)
    state = module.init_state(0, batch)
    state.step = 2
    profiling.enable()
    module.train_step(state, batch, seed=5, metrics=False)
    profiling.disable()
    recs = profiling.records()
    (backward,) = [r for r in recs if r.name == "train.backward"]
    out = {"names": [r.name for r in recs], "units": {r.unit for r in recs},
           "in backward": sum(r.name == "dp.allreduce.moments"
                              and backward.start_ns <= r.start_ns <= r.end_ns <= backward.end_ns
                              for r in recs)}
    torch.save(out, sys.argv[3] + f"/rank{rank}.pt")
    print(f"OK rank {rank}")
''')


def test_gloo_step_counts_its_all_reduces(tmp_path):
    """Every all-reduce of a world-2 DMSCT step is a ``dp.allreduce.*`` span:
    2 for each train-mode BatchNorm applied (its moments, forward and
    backward; the encoder runs on both views), one for each gradient bucket
    and one for the logs (DMSCT has no masked mean, so no rank_mean)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), coord, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {r}" in out, f"rank {r}:\n{out[-4000:]}"

    module = _dmsct_module()
    applied = 2 * sum(isinstance(m, _BN) for m in module.model.encoder.modules())
    trainable = [p for n, p in module.model.named_parameters() if not n.startswith("matcher.")]
    want = {"dp.allreduce.moments": 2 * applied, "dp.allreduce.rank_mean": 0,
            "dp.allreduce.grads": len(gradient_buckets(trainable)), "dp.allreduce.logs": 1}
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        counted = {k: got["names"].count(k) for k in want}
        assert counted == want
        assert sum(n.startswith("dp.allreduce.") for n in got["names"]) == sum(want.values())
        assert got["in backward"] == applied and got["units"] == {2}
