"""A cell as ``BENCHMARK.json`` names it, with the files found by its names:
the configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the output limits (``limits/<cell>.json``)
and one reader per per-layer metric (``metrics/<metric>.py``)."""

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


def reader(name, directory=HERE / "metrics"):
    """The reader module of the per-layer metric ``name``."""
    path = Path(directory) / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def readers(self):
        return {m["name"]: reader(m["name"]) for m in self.per_layer}


def load(name, root=ROOT):
    bench = _json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        chips=w["chips"],
        config=_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=traffic_mod.load(w["traffic"]),
        traffic_name=w["traffic"],
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
