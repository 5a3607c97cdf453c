"""The output check on the cards at each cell's own size, on three seeds:
the control (the reference computed in TF32, one step below the
configurations' float32, put in the program's place) fails the cell's
limits, and so do the faults read here; the program's own runs pass. (On
the CPU, which has no TF32, the program's bf16 recipe stands in:
test_bench_harness.py.)

Run on the cards: ``python3 -m pytest benchmark/tests/test_bench_control.py``."""

import json
import time

import pytest
import torch

from benchmark import calibrate
from benchmark import cell as cell_mod
from benchmark.cell import ROOT

WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s): the cell runs at its own size")
    return torch.device("cuda")


def _passes(numbers, limits):
    return all(numbers[k] <= lim["limit"] for k, lim in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in WORKLOADS])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_fail(name, seed):
    """``calibrate``'s readings: the control and the half-batch fault fail
    (the half batch on the step's loss too), the program (read here for a
    one-chip cell) passes."""
    device = _cards(1)
    cell = cell_mod.load(name)
    read = {"serve": calibrate.serve_seed, "fit": calibrate.fit_seed}[cell.traffic["kind"]]
    out = read(cell, seed, device)
    print(json.dumps({"workload": name, "seed": seed, **out}))
    if "program" in out:
        assert _passes(out["program"], cell.limits), out
    assert not _passes(out["control"], cell.limits), out
    if "half_batch" in out:
        assert not _passes(out["half_batch"], cell.limits), out
        # the loss alone catches it: the mean over half the rows
        assert out["half_batch"]["loss_rel"] > cell.limits["loss_rel"]["limit"], out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in WORKLOADS if w["chips"] > 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_left_out_exchange_fails_over_the_cards(name, seed, capfd):
    """A run over the cell's cards with the gradient average left out."""
    from benchmark.ranks import launch

    cell = cell_mod.load(name)
    _cards(cell.chips)
    code = launch(cell, seed, 5.0, False, time.perf_counter(), fault="no_exchange")
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("{")]
    result = json.loads(lines[-1])
    print(json.dumps(result["checks"]))
    assert code == 0 and result["correct"] is False
