"""The benchmark of repkiller_tpu_torch: one run of one cell.

    python3 rkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether the
outputs were correct, the jobs attempted and failed, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
and the device. Every number compared with the plain reference is printed
beside its limit as the last lines of standard error and under the
result's last key, "checks". Without as many CUDA devices as the cell
asks for, it prints no result and exits with 2. Files go under $TMPDIR
and are removed at the end.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from harness import check, manifest  # noqa: E402


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from harness import driver, roofline

    name = torch.cuda.get_device_name(0)
    log(f"# {args.workload}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace} on {roofline.smi('name,power.limit')}")
    workdir = tempfile.mkdtemp(prefix="rkbench-")
    try:
        run, numbers = driver.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda:0", workdir,
                                       T0, log=log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = driver.loaded_forbidden()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3

    walls = [j.end - j.start for j in run.jobs]
    log("# job walls (s): " + " ".join(f"{w:.4f}" for w in walls))
    log(f"# jobs {len(run.jobs)} (failed {len(run.jobs) - len(run.done)}), "
        f"median wall {sorted(walls)[len(walls) // 2]:.6f} s, set-up "
        f"{run.setup_s:.6f} s")
    entries = cell.per_layer if args.trace else cell.end_to_end
    result = {
        "correct": check.verdict(numbers),
        "attempted": len(run.jobs),
        "failed": len(run.jobs) - len(run.done),
        "metrics": manifest.read_metrics(entries, run),
        "device": {"platform": "gpu", "kind": name, "count": cell.chips,
                   "memory_peak_bytes": int(run.peak_bytes)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        log(f"# traced jobs: device busy {run.trace.busy_s} of "
            f"{run.trace.window_s} s; stage walls {run.stages}; spans "
            f"{run.spans}")
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    for k, v in numbers.items():
        log(f"{k} {v} (limit {check.LIMITS[k]})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
