"""BENCHMARK.json loads, keeps to the benchmark's contract, and every cell
finds its configuration, traffic and metric readers by name."""

import json
import re

import pytest

import _tiny  # noqa: F401  (puts the harness on sys.path)
from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "rkbench/run.py"]
    assert m["paths"] == ["rkbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) < 64 * 1024


def test_a_full_check_fits_with_24_cells(m):
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds(m):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in m[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in m[key]}) == len(m[key])
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert set(e2e) == {"throughput_mbp_s", "job_p95_s", "device_peak_gib",
                        "setup_s"}
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    layers = {}
    for e in m["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(e["unit"]) and e["source"] in SOURCES
        assert e["moves"] in e2e
        layers.setdefault(e["layer"], e["layer"])
    assert e2e["setup_s"]["bound"] == 0.25


def test_each_cell_finds_its_files_and_reports_enough(m):
    cells = {w["name"] for w in m["workloads"]}
    for e in m["per_layer"]:
        assert set(e["workloads"]) <= cells
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert "extend_mode" in cell.settings
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for e in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(e["name"]))


def test_configs_lie_under_paths_and_state_their_cuts(m):
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert c["file"].startswith("rkbench/configs/")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        with open(manifest.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] == []
        assert sum(r["length"] for r in conf["records"]) > 4_000_000
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
