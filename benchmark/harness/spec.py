"""A cell's files, found by the names in BENCHMARK.json: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its correctness check
(``limits/<workload>.json``) and a reader per per-layer metric
(``metrics/<metric>.py``, or one reader for the split quantity
``metrics/<quantity>.py`` where the metric is ``<quantity>.<part>``)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        """Which loop runs the cell's traffic: "serve" or "train"."""
        return self.traffic["kind"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str, moved: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in moved


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with every file it names; KeyError or
    FileNotFoundError where one is missing."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, moved)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or where there is none, the reader of the
    quantity the name splits: ``metrics/mfu.py`` for ``mfu.train``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def reader(metric: str) -> Callable:
    """``read(ctx)`` of the metric's reader (``reader_path``)."""
    path = reader_path(metric)
    mod_name = "metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric's reading, left out where its reader finds
    nothing to read."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
