"""A cell as ``BENCHMARK.json`` names it, with the files found by its names
under the benchmark's directory: the configuration (the file its entry in
``configs`` names), its plain reference (``reference/<reference>.py``), the
traffic mix (``traffic/<traffic>.json``), the output limits
(``limits/<cell>.json``), the FLOPs of a frame or step
(``flops/<cell>.json``, where the cell has a count) and one reader per
per-layer metric (``metrics/<metric>.py``)."""

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

from benchmark import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name, directory=HERE / "metrics"):
    """The reader module of the per-layer metric ``name``."""
    return _module(Path(directory) / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_name: str
    limits: dict
    flops: dict = None
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    home: Path = HERE

    def readers(self):
        return {m["name"]: reader(m["name"], self.home / "metrics") for m in self.per_layer}

    def reference(self):
        """The configuration's plain reference module, loaded from its file."""
        name = self.config["reference"]
        return _module(self.home / "reference" / f"{name}.py", "benchmark_reference_" + name)


def load(name, root=ROOT):
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files read from
    ``<root>/benchmark``."""
    root = Path(root)
    home = root / "benchmark"
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    flops = home / "flops" / f"{name}.json"
    return Cell(
        name=name,
        chips=w["chips"],
        config=_json(root / config["file"]),
        traffic=traffic_mod.load(w["traffic"], home / "traffic"),
        traffic_name=w["traffic"],
        limits=_json(home / "limits" / f"{name}.json"),
        flops=_json(flops) if flops.exists() else None,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        home=home,
    )
