"""The harness on the CPU at tiny shapes: the result line's keys, names and
units; the output check on sound runs, on each configuration's own
lower-precision recipe, and with the timed path broken underneath (every
fault a one-chip cell's kind can have); a configuration and a traffic added
as new files only. The card's own runs of the control are in
test_bench_control.py."""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import cell as cell_mod
from benchmark import faults, serve, trace
from benchmark.cell import HERE, ROOT
from benchmark.faults import plant
from benchmark.peaks import reference_flops
from benchmark.run import RunView, execute, main
from benchmark.run_common import Outcome
from benchmark.traffic import serve_clip

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


@pytest.mark.parametrize("name", CELLS)
def test_a_bf16_run_is_not_correct(name):
    """The port's own lower-precision recipe (bf16), which the
    configuration's file names (``lower_precision_kwargs``), in the
    program's place: its output departs from the float32 reference by more
    than the limits allow."""
    cell = tiny(name)
    cell.config["kwargs"].update(cell.config["lower_precision_kwargs"])
    assert run(cell)["correct"] is False


def _faults(names):
    """(cell name, fault) for every fault each cell's kind and chips can have."""
    cells = [cell_mod.load(name) for name in names]
    return [(c.name, fault) for c in cells for fault in faults.of(c.traffic["kind"], c.chips)]


@pytest.mark.parametrize("name,fault", _faults(CELLS))
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(name)
    with plant(fault, cell.config):
        assert run(cell)["correct"] is False


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


def _view(cell, digest, spans, shapes, records=(), units=4, window_s=1.0):
    out = Outcome(attempted=units, failed=0, units=units, window_s=window_s, setup_s=1.0,
                  peak_bytes=0, numbers={}, e2e={}, spans=spans, span_shapes=shapes,
                  digest=digest)
    return RunView(cell, out, records)


# The port's span records of a traced window (utils/profiling.py's Record):
# every span a reader of the port's spans reads, over two train steps, each
# lying over the device trace's one idle gap (2900-3000 us).
PORT_SPANS = ("video.call", "gmflow.refine", "gmflow.transformer", "train.backward",
              "dp.allreduce.moments", "dp.allreduce.grads")


def _records():
    recs = [SimpleNamespace(name="train.step", start_ns=400_000, end_ns=9_400_000, thread=1,
                            id=unit + 1, device_ms=None, unit=unit) for unit in (0, 1)]
    recs += [SimpleNamespace(name=name, start_ns=500_000 + 1000 * i, end_ns=9_300_000,
                             thread=1, id=10 + i, device_ms=6.0, unit=i % 2)
             for i, name in enumerate(PORT_SPANS)]
    return recs


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
    full = _view(cell, {"busy_s": 0.9, "window_s": 1.0, "device_events": events}, spans, shapes,
                 _records())
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


@pytest.mark.parametrize("name,fault", _faults(MULTI))
def test_a_broken_step_over_ranks_is_not_correct(name, fault, capfd):
    code, result = _ranks(name, fault, capfd)
    assert code == 0 and result["correct"] is False
    if fault == "half_batch":  # the loss of half the rows is not the batch's
        loss = result["checks"]["loss_rel"]
        assert loss["value"] > loss["limit"]


def _gaps_before(kept, want):
    """``serve.gaps`` as it stood while it read DMSCT's matcher outputs by
    name, on the reference's frames ``want``: kept to pin the numbers."""
    frame, frame_mean, flow, occ = 0.0, [], 0.0, 0.0
    for (_, out, match), (_, ref_out, ref_match) in zip(kept, want):
        d = np.abs(out - ref_out)
        frame = max(frame, float(d.max()))
        frame_mean.append(float(d.mean()))
        flow = max(flow, float((match["flow"] - ref_match["flow"]).abs().max()))
        occ = max(occ, float((match["fwd_occ"] != ref_match["fwd_occ"]).float().mean()))
    return {"frame_max_abs": frame, "frame_mean_abs": float(np.mean(frame_mean)),
            "flow_max_px": flow, "occ_mismatch": occ}


def test_dmsct_serving_numbers_are_bit_equal_to_the_check_before():
    """The check that reads its outputs from the configuration gives DMSCT's
    four numbers, in their order, bit for bit as the check that named them:
    on the program's kept frames and on the same frames bent far off."""
    cpu = torch.device("cpu")
    cell = tiny("dmsct.serve_1080p")
    weights = serve.setup_weights(cell, SEED, cpu)
    module, serve_fn = serve.program(cell.config, weights, cpu)
    clip = serve_clip(cell.traffic, SEED, cpu)
    capture = serve.Capture(module.model, cell.config["capture"])
    capture.armed = True
    idxs = list(range(cell.traffic["clip_frames"]))
    kept = [(i, serve_fn(clip[0][i:i + 1], clip[1][i:i + 1]), capture.take()) for i in idxs]
    capture.close()
    bent = [(i, 1.0 - out, {"flow": m["flow"] + 0.5 * (i + 1), "fwd_occ": 1.0 - m["fwd_occ"]})
            for i, out, m in kept]
    want = serve.reference_frames(cell, weights, clip, idxs, cpu)
    for frames in (kept, bent):
        numbers = serve.gaps(frames, clip, cell, weights, cpu)
        assert list(numbers.items()) == list(_gaps_before(frames, want).items())
    assert all(v > 0 for v in serve.gaps(bent, clip, cell, weights, cpu).values())


# A configuration and a traffic added to the benchmark as new files and
# entries only: DCMCS3DI served at a tiny depth, whose reference captures no
# output beside the corrected frame, and a new traffic for dmsct.
SERVED_REFERENCE = '''"""DCMCS3DI served: the reference forward on (target, reference) -> the
corrected frame, and no output beside it."""

from benchmark.reference.dcmcs3di import CUDNN, build, train_loss, trainable  # noqa: F401


def serve(model, target, reference):
    return model(target, reference)[0], {}
'''
DC_TINY = {"name": "dcmcs3di_tiny",
           "source": "https://github.com/egorchistov/color-transfer/blob/main/configs/dcmcs3di.yaml",
           "method": "dcmcs3di", "module": "DCMCS3DIModule",
           "kwargs": {"extraction_layers": 2, "transfer_layers": 1, "channels": 64},
           "reference": "dcmcs3di_served",
           "sizes": {"extraction_layers": 2, "transfer_layers": 1, "channels": 64},
           "published": {"extraction_layers": 18, "transfer_layers": 6},
           "init": "uniform_fan_in", "capture": {},
           "reduced": ["extraction_layers", "transfer_layers"],
           "lower_precision_kwargs": {"compute_dtype": "bfloat16"}}
NEW_TRAFFIC = {"serve_64x96": {"kind": "serve", "height": 64, "width": 96, "clip_frames": 2,
                               "scene_grid": [4, 6], "shift_px": [2, 8], "gain": [0.85, 1.0],
                               "offset": [0.0, 0.08], "warmup_frames": 1, "check_frames": 2}}
NEW_CELLS = {"dcmcs3di_tiny.serve_64x96": ("dcmcs3di_tiny", "serve_64x96"),
             "dmsct.serve_64x96": ("dmsct", "serve_64x96")}
NEW_LIMITS = {
    "dcmcs3di_tiny.serve_64x96": {
        "frame_mean_abs": {"limit": 2e-06, "lower": 0.0, "upper": 4.5e-03}},
    "dmsct.serve_64x96": json.loads((HERE / "limits" / "dmsct.serve_1080p.json").read_text()),
}


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """A checkout's root holding the benchmark as it is, then the new
    configuration, reference, traffic, limits and FLOPs as files that did
    not exist, and their entries in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("room")
    home = root / "benchmark"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns("__pycache__"))

    def add(relative, text):
        path = home / relative
        assert not path.exists(), relative  # new files only
        path.parent.mkdir(exist_ok=True)
        path.write_text(text)

    add("configs/dcmcs3di_tiny.json", json.dumps(DC_TINY))
    add("reference/dcmcs3di_served.py", SERVED_REFERENCE)
    for name, mix in NEW_TRAFFIC.items():
        add(f"traffic/{name}.json", json.dumps(mix))
    for name, limits in NEW_LIMITS.items():
        add(f"limits/{name}.json", json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dcmcs3di_tiny", "source": DC_TINY["source"],
                             "file": "benchmark/configs/dcmcs3di_tiny.json",
                             "reduced": DC_TINY["reduced"], "why": "served, capturing nothing"})
    bench["workloads"] += [{"name": name, "config": config, "traffic": traffic, "chips": 1,
                            "why": "a cell added as files"}
                           for name, (config, traffic) in NEW_CELLS.items()]
    for metric in bench["end_to_end"]:
        if metric["name"] in ("frames_per_s", "frame_ms_p90"):
            metric["workloads"] += list(NEW_CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in NEW_CELLS:  # counted as a PR that adds the cell counts it
        cell = cell_mod.load(name, root)
        shape = [1, cell.traffic["height"], cell.traffic["width"], 3]
        add(f"flops/{name}.json", json.dumps(
            {"per": "frame", "shape": shape, "flops": reference_flops(cell, shape)}))
    return root


@pytest.mark.parametrize("name", sorted(NEW_CELLS))
def test_a_cell_added_as_files_only_runs_correct(room, name):
    cell = cell_mod.load(name, room)
    result = run(cell)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(cell.limits)
    assert {k: v["unit"] for k, v in result["metrics"].items()} == \
        {m["name"]: m["unit"] for m in cell.end_to_end}
    out = Outcome(attempted=1, failed=0, units=1, window_s=1.0, setup_s=1.0, peak_bytes=0,
                  numbers={}, e2e={})
    assert RunView(cell, out).flops_per_unit == cell.flops["flops"] > 0


def test_a_configuration_added_as_files_only_catches_its_faults(room):
    """DCMCS3DI's serving cell: each fault of its kind, and its bf16 recipe,
    make the line incorrect."""
    cell = cell_mod.load("dcmcs3di_tiny.serve_64x96", room)
    for fault in faults.of(cell.traffic["kind"], cell.chips):
        with plant(fault, cell.config):
            assert run(cell)["correct"] is False, fault
    cell.config["kwargs"].update(cell.config["lower_precision_kwargs"])
    assert run(cell)["correct"] is False
