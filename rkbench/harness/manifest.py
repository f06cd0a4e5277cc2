"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``)
and a reader per metric (``metrics/<metric>.py``), each found by its name
in the manifest."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]         # metric entries this cell reports
    per_layer: List[dict]

    @property
    def settings(self) -> dict:
        """The program's Config fields: the configuration's, then the
        traffic's."""
        return {**self.config["config"], **self.traffic["config"]}


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    m = load_manifest(root)
    try:
        w = next(w for w in m["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, w["chips"], config, traffic,
                [e for e in m["end_to_end"] if _reports(e, name)],
                [e for e in m["per_layer"] if _reports(e, name)])


def reader(metric: str) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"rkbench_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for e in entries:
        value = reader(e["name"])(run)
        if value is not None:
            out[e["name"]] = {"value": value, "unit": e["unit"]}
    return out
