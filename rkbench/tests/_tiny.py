"""Shared helpers of the benchmark's CPU tests: the benchmark's cells cut
to sizes a CPU test holds, run through the harness on the CPU."""

import copy
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import driver, manifest  # noqa: E402

SEED = 2**31 + 77


def tiny_cell(name: str, length: int = 9000, pool: int = 2, **settings):
    """The cell ``name`` with every record ``length`` bp long, a pool of
    ``pool`` genomes (or pairs) and capacities for that size; a pair's
    strain B shrinks with A, its insertion in proportion. ``settings``
    override Config fields."""
    cell = manifest.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    strain_b = cell.config.get("strain_b")
    if strain_b is not None:
        full = cell.config["records"][0]["length"]
        strain_b["insertion_bp"] = max(
            1, strain_b["insertion_bp"] * length // full)
    for rec in cell.config["records"]:
        rec["length"] = length
    cell.config["pool"] = pool
    cell.config["profiled_jobs"] = 1
    cell.config["config"].update(hit_capacity=1 << 16, seed_capacity=1 << 15,
                                 **settings)
    return cell


def run_tiny(cell, trace: bool = False, seed: int = SEED):
    """One run of ``cell`` on the CPU with a window of one job -> (Run,
    the numbers compared)."""
    with tempfile.TemporaryDirectory() as d:
        return driver.run_cell(cell, seed, 0.0, trace, "cpu", d,
                               time.perf_counter(), log=lambda *a: None)
