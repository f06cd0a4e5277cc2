"""Rank 0 of a tiny run of the four-card cell on the CPU, in a process of
its own, as the rank tests start it (a fault can end this process):

    python _rank0.py <json: {"length", "seed", "settings", "mode",
                             "one_process", "fault", "seconds", "trace"}>

Prints one JSON line: the numbers compared, the jobs, the peak and a
sha256 of every checked table."""

import hashlib
import json
import os
import sys
import tempfile
import time

from _tiny import tiny_cell
from harness import driver, ranks

import numpy as np

CELL = "human_chr1.sharded4"
FIELDS = ("xStart", "yStart", "xEnd", "yEnd", "strand", "length", "score",
          "idents", "group")


def table_sha(frag) -> str:
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(frag[f], np.int32).tobytes())
    return h.hexdigest()


def main(spec: dict) -> int:
    cell = tiny_cell(CELL, length=spec.get("length", 20000))
    cell.config["config"].update(spec.get("settings", {}))
    cell.traffic["config"]["extend_mode"] = spec.get("mode", "ungapped")
    if spec.get("one_process"):
        cell.chips = 1
    if spec.get("fault"):
        ranks.HELPER = ranks.HELPER.parent / "tests" / "_faulty_rank.py"
        os.environ["RKBENCH_TEST_FAULT"] = json.dumps(spec["fault"])
        ranks.CONTROL_TIMEOUT_S = spec["fault"].get(
            "control_timeout_s", ranks.CONTROL_TIMEOUT_S)
        if "program" in spec["fault"]:
            from _faulty_rank import plant_program
            plant_program(spec["fault"]["program"])
    tables = {}
    orig = driver.check.compare

    def compare(got, files, want, want_files):
        tables.setdefault("sha", []).extend(table_sha(t) for t in got)
        tables.setdefault("files", []).extend(
            hashlib.sha256(b"".join(f[k] or b"" for k in sorted(f))).hexdigest()
            for f in files)
        return orig(got, files, want, want_files)
    driver.check.compare = compare
    with tempfile.TemporaryDirectory() as d:
        run, numbers = driver.run_cell(
            cell, spec.get("seed", 2**31 + 77), spec.get("seconds", 0.0),
            spec.get("trace", False), "cpu", d, time.perf_counter(),
            log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps({"numbers": numbers, "jobs": len(run.jobs),
                      "done": len(run.done), "peak": run.peak_bytes,
                      "trace": None if run.trace is None else
                      [run.trace.busy_s, run.trace.window_s],
                      **tables}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(json.loads(sys.argv[1])))
