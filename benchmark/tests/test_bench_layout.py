"""The benchmark's files against its own rules: what it imports, the layout
``BENCHMARK.json`` names, and the FLOP counts the cells keep."""

import ast
import json
import re

import pytest

from benchmark import cell as cell_mod
from benchmark.cell import HERE, ROOT
from benchmark.peaks import reference_flops

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    resolve inside ``benchmark``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "benchmark", f"benchmark.{node.module or ''}"
            else:
                yield node.module.split(".")[0], node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    bad = {"jax", "jaxlib", "flax", "color_transfer_tpu"}
    assert not [full for top, full in _imports(path) if top in bad]


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not [full for top, full in _imports(path) if top == "color_transfer_tpu_torch"]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert all(0 < len(e["why"]) <= 200 and "\n" not in e["why"]
               for key in ("configs", "workloads") for e in BENCH[key])
    assert len(set(n for e in ("end_to_end", "per_layer") for n in
                   (m["name"] for m in BENCH[e]))) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = cell_mod.load(cell)
    assert c.chips in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 3 and c.per_layer
    for lim in c.limits.values():  # an exact comparison has the limit 0
        assert lim["lower"] < lim["limit"] < lim["upper"] or lim["lower"] == lim["limit"] == 0
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert set(c.readers()) == {m["name"] for m in c.per_layer}
    if any(m["name"].startswith("mfu") for m in c.per_layer):  # the count it reads
        assert c.flops is not None


def _sizes(data):
    """A configuration's keys and those of its ``sizes``."""
    return {**data, **data.get("sizes", {})}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    """The file is the entry's, and every key ``reduced`` lists is in it with
    its published value beside it (``published``), which it departs from."""
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    published = data.get("published", {})
    for key in config["reduced"]:
        assert key in _sizes(data) and key in published, key
        assert _sizes(data)[key] != published[key], key


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_stored_flops_recount(cell):
    c = cell_mod.load(cell)
    entry = c.flops
    assert entry["per"] == {"serve": "frame", "fit": "step"}[c.traffic["kind"]]
    b = c.traffic.get("batch", 1)  # serving hands over one frame pair a call
    assert entry["shape"] == [b, c.traffic["height"], c.traffic["width"], 3]
    assert reference_flops(c, entry["shape"]) == entry["flops"]
