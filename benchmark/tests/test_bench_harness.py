"""The harness on the CPU at tiny shapes: the result line's keys, names and
units; the output check on sound runs, on the program's bf16 recipes, and
with the timed path broken underneath (every fault a one-chip cell can
have). The card's own runs of the control are in test_bench_control.py."""

import json

import numpy as np
import pytest
import torch

from benchmark import cell as cell_mod
from benchmark import trace
from benchmark.cell import ROOT
from benchmark.faults import plant
from benchmark.run import RunView, execute, main
from benchmark.run_common import Outcome

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {"serve": {"height": 64, "width": 96, "clip_frames": 3, "warmup_frames": 1},
        "fit": {"height": 16, "width": 32, "batch": 2, "pool_batches": 3}}
SEED = 2**33 + 17  # a seed may pass 32 bits


def tiny(name, **kwargs):
    cell = cell_mod.load(name)
    cell.traffic.update(TINY[cell.traffic["kind"]])
    cell.config["kwargs"].update(kwargs)
    return cell


def run(cell, seconds=0.5):
    import time

    return execute(cell, SEED, seconds, False, "cpu", time.perf_counter())[0]


CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
MULTI = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = tiny(name)
    result = run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] >= 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell.limits)
    json.dumps(result)


BF16 = {"dmsct.serve_1080p": {"matcher_compute_dtype": "bfloat16",
                              "corrector_compute_dtype": "bfloat16"},
        "dcmcs3di.fit_160x320": {"compute_dtype": "bfloat16"}}


@pytest.mark.parametrize("name", CELLS)
def test_a_bf16_run_is_not_correct(name):
    """The port's own bf16 recipe in the program's place: its output departs
    from the float32 reference by more than the limits allow."""
    assert run(tiny(name, **BF16[name]))["correct"] is False


FAULTS = [("dmsct.serve_1080p", "altered_answer"),
          ("dcmcs3di.fit_160x320", "unchanged_state"),
          ("dcmcs3di.fit_160x320", "half_batch")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    with plant(fault):
        assert run(tiny(name))["correct"] is False


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


class _Prof:
    """A stand-in for the profiler's raw results."""

    def __init__(self, events):
        class E:
            def __init__(self, name, start, dur, dev):
                self._n, self._s, self._d, self._dev = name, start, dur, dev

            def name(self):
                return self._n

            def start_ns(self):
                return self._s * 1000

            def duration_ns(self):
                return self._d * 1000

            def device_type(self):
                return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

        class R:
            def events(self):
                return [E(*e) for e in events]

        class P:
            kineto_results = R()

        self.profiler = P()


def test_digest_busy_gaps_and_breakdown():
    prof = _Prof([("k1", 0, 10, True), ("k2", 5, 10, True), ("k1", 40, 10, True),
                  ("Memcpy HtoD (Pageable -> Device)", 60, 5, True),
                  ("aten::copy_", 14, 30, False), ("cudaLaunchKernel", 45, 20, False)])
    d = trace.digest(prof, 1e-4)
    assert d["busy_s"] == pytest.approx(30e-6)
    assert d["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert "idle_gaps" not in d  # labelled from the pass that records host ops
    assert trace.idle_gaps(prof) == [["aten::copy_", pytest.approx(25e-6)],
                                     ["cudaLaunchKernel", pytest.approx(10e-6)]]


def _view(cell, digest, spans, shapes, units=4, window_s=1.0):
    out = Outcome(attempted=units, failed=0, units=units, window_s=window_s, setup_s=1.0,
                  peak_bytes=0, numbers={}, e2e={}, spans=spans, span_shapes=shapes,
                  digest=digest)
    return RunView(cell, out)


@pytest.mark.parametrize("name", CELLS + MULTI)
def test_readers_read_their_layer_and_nothing_else(name):
    """Every per-layer reader of a cell returns a number from a trace that
    holds its layer, and nothing (left out of the line) from one that does
    not; no share passes 100%."""
    cell = cell_mod.load(name)
    readers = cell.readers()
    spans = {s: 40.0 for r in readers.values() for s in getattr(r, "SPANS", {})}
    shapes = {s: [[(2, 128, 224, 128)]] * 24 for s in spans}
    events = [("void local_corr_kernel<float, 4>", 0.0, 2000.0), ("Memcpy DtoH", 2000.0, 2900.0),
              ("Memcpy HtoD", 3000.0, 4000.0), ("gemm", 4000.0, 9000.0),
              ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 9000.0, 9500.0)]
    full = _view(cell, {"busy_s": 0.9, "window_s": 1.0, "device_events": events}, spans, shapes)
    empty = _view(cell, {"busy_s": 0.9, "window_s": 1.0, "device_events": []}, {}, {})
    for metric in cell.per_layer:
        value = readers[metric["name"]].read(full)
        assert value is not None and np.isfinite(value) and value > 0, metric["name"]
        if metric["unit"] == "%":
            assert value <= 100.0
        if getattr(readers[metric["name"]], "SPANS", None) or any(
                k in metric["name"] for k in ("roofline", "copy", "allreduce")):
            assert readers[metric["name"]].read(empty) is None


def _ranks(name, fault, capfd):
    """A multi-card cell on two gloo ranks on the CPU, ``fault`` planted in
    each -> (exit code, rank 0's result line)."""
    import time

    from benchmark.ranks import launch

    cell = tiny(name)
    cell.chips = 2
    cell.traffic.update(height=32, width=64, batch=4)
    code = launch(cell, SEED, 0.5, False, time.perf_counter(), device="cpu", fault=fault)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("{")]
    return code, json.loads(lines[-1])


@pytest.mark.parametrize("name", MULTI)
def test_ranks_agree_and_report_once(name, capfd):
    code, result = _ranks(name, None, capfd)
    assert code == 0 and result["device"]["count"] == 2
    assert result["checks"]["ranks_differ"]["value"] == 0.0
    loss = result["checks"]["loss_rel"]
    assert loss["value"] <= loss["limit"]  # the global batch's loss, on rank 0
    cell = cell_mod.load(name)
    assert set(result["checks"]) == set(cell.limits)
    assert {k: v["unit"] for k, v in result["metrics"].items()} == \
        {m["name"]: m["unit"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", MULTI)
@pytest.mark.parametrize("fault", ["no_exchange", "unchanged_state", "half_batch"])
def test_a_broken_step_over_ranks_is_not_correct(name, fault, capfd):
    code, result = _ranks(name, fault, capfd)
    assert code == 0 and result["correct"] is False
    if fault == "half_batch":  # the loss of half the rows is not the batch's
        loss = result["checks"]["loss_rel"]
        assert loss["value"] > loss["limit"]
