"""The ``dcmcs3di_serve`` configuration on the CPU: its real file, reference
and limits in a copied root with a tiny traffic added as a file (48x96
frames), where a run is correct on either of the port's serving routes and
every way of computing below the configuration's float32 is not: each fault
a one-chip serving cell can have, the bf16 recipe, and B5 on bf16 operands
inside the float32 recipe. Then the readers of its three per-layer metrics
on synthetic spans."""

import json
import shutil
import time
from types import SimpleNamespace

import pytest

from benchmark import cell as cell_mod
from benchmark import faults
from benchmark.cell import HERE, ROOT
from benchmark.faults import plant
from benchmark.peaks import reference_flops
from benchmark.run import execute

CELL = "dcmcs3di.serve_48x96"
TRAFFIC = {"kind": "serve", "height": 48, "width": 96, "clip_frames": 3, "scene_grid": [4, 6],
           "shift_px": [2, 8], "gain": [0.85, 1.0], "offset": [0.0, 0.08],
           "warmup_frames": 1, "check_frames": 2}
SEED = 2**33 + 29


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """A checkout's root holding the benchmark as it is, a 48x96 traffic and
    a cell of the real ``dcmcs3di_serve`` configuration on it, with the
    limits of ``dcmcs3di.serve_1080p``."""
    root = tmp_path_factory.mktemp("room")
    home = root / "benchmark"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns("__pycache__"))
    (home / "traffic" / "serve_48x96.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(HERE / "limits" / "dcmcs3di.serve_1080p.json", home / "limits" / f"{CELL}.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "dcmcs3di_serve",
                               "traffic": "serve_48x96", "chips": 1, "why": "tiny"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "dcmcs3di.serve_1080p" in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cell_mod.load(CELL, root)
    shape = [1, 48, 96, 3]
    (home / "flops" / f"{CELL}.json").write_text(json.dumps(
        {"per": "frame", "shape": shape, "flops": reference_flops(cell, shape)}))
    return root


def _run(cell):
    return execute(cell, SEED, 0.3, False, "cpu", time.perf_counter())[0]


@pytest.fixture
def no_room(monkeypatch):
    """Every batch's materialised volumes too large for its card: the port's
    row-attention route (``run/modules.py::materialised_matcher_fits``)."""
    from color_transfer_tpu_torch.run import modules

    monkeypatch.setattr(modules, "materialised_matcher_fits", lambda target: False)


def test_the_configuration_runs_correct(room):
    cell = cell_mod.load(CELL, room)
    assert cell.config["reduced"] == [] and "use_kernels" not in cell.config["kwargs"]
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"frame_mean_abs", "frame_max_abs"}


def test_the_row_attention_route_runs_correct(room, no_room):
    result = _run(cell_mod.load(CELL, room))
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", faults.of("serve", 1))
def test_each_fault_is_not_correct(room, fault):
    cell = cell_mod.load(CELL, room)
    with plant(fault, cell.config):
        assert _run(cell)["correct"] is False


def test_the_bf16_recipe_is_not_correct(room):
    cell = cell_mod.load(CELL, room)
    cell.config["kwargs"].update(cell.config["lower_precision_kwargs"])
    assert _run(cell)["correct"] is False


def test_b5_on_bf16_operands_is_not_correct(room, monkeypatch, no_room):
    """The f32 recipe on the row-attention route with its operands in bf16
    (``precise`` False), a lower precision than the configuration states."""
    from color_transfer_tpu_torch.models import dcmcs3di as dcm

    inner = dcm.fused_parallax_inference
    monkeypatch.setattr(dcm, "fused_parallax_inference",
                        lambda *a, precise, **k: inner(*a, precise=False, **k))
    result = _run(cell_mod.load(CELL, room))
    assert result["correct"] is False, result["checks"]


# The readers of the cell's own per-layer metrics, and the spans each sums.
SPAN_READERS = {"dc_extraction_ms_per_frame.serve": ["dc_extraction"],
                "dc_attention_ms_per_frame.serve": ["dc_cost", "dc_value", "dc_softmax",
                                                    "dc_warp"],
                "dc_transfer_ms_per_frame.serve": ["dc_transfer"]}


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers(metric):
    reader = cell_mod.reader(metric)
    names = SPAN_READERS[metric]
    assert sorted(reader.SPANS) == sorted(names)
    spans = {name: 3.0 * (i + 1) for i, name in enumerate(names)}
    spans["matcher"] = 50.0  # another reader's
    view = SimpleNamespace(spans=spans, units=2)
    assert reader.read(view) == pytest.approx(sum(3.0 * (i + 1) for i in range(len(names))) / 2)
    assert reader.read(SimpleNamespace(spans={names[0]: 0.0}, units=2)) is None
    assert reader.read(SimpleNamespace(spans={}, units=2)) is None  # no span recorded


def test_attention_reads_nothing_on_the_row_attention_route():
    """A window on the row-attention route calls no ``matcher``: the value
    conv alone is not the attention's time."""
    reader = cell_mod.reader("dc_attention_ms_per_frame.serve")
    assert reader.read(SimpleNamespace(spans={"dc_value": 2.0}, units=2)) is None
