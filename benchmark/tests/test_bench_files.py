"""Every cell's files are found by the names in BENCHMARK.json, and the
file keeps to the benchmark's contract."""

import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = spec.load(workload)
    assert cell.kind in ("serve", "train")
    assert cell.limits["limits"], "a cell compares at least one number"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_keys_names_and_units():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCHMARK["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCHMARK["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert c["file"].startswith("benchmark/")
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


def test_every_metric_has_a_reader_and_no_stray_reader():
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    used = {spec.reader_path(m["name"]).name[:-3]
            for m in BENCHMARK["per_layer"]}
    assert all(spec.reader_path(m["name"]).is_file()
               for m in BENCHMARK["per_layer"])
    assert readers == used


def test_config_widths_match_the_checkpoints():
    """The sizes in each configuration file are the committed
    checkpoint's: every array the reference builds a path from has the
    shape the sizes give it."""
    from reference.net import Checkpoint, Path

    for c in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        ckpt = Checkpoint(str(ROOT / cfg["checkpoint"]), cfg["checkpoint_task"])
        sizes = cfg["net"]
        for t in range(cfg["tasks"]):
            path = Path(ckpt, t, sizes, "cpu")
            for group in ("feature_stems", "matching_stems", "heads"):
                for site, (cin, cout, k, *_rest) in sizes[group].items():
                    assert path.params[f"{site}/w"].shape[-2:] == (cin, cout)
                    assert path.params[f"{site}/w"].shape[0] == k
