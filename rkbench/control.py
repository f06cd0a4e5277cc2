"""The control of a cell's correctness check: the plain reference, cut to the
traffic's ``control_max_extend`` (the phase-1 row cap of the banded
extension, or the first chunk of the ungapped scan: the shortcut a faster
program would be tempted by), put in the program's place and judged by
the same comparison a run makes. It has to come out not correct.

    python3 rkbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed with the numbers compared and the verdict.
The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

from harness import check, genomes, manifest, reference, report  # noqa: E402
from harness.driver import checked_genomes, parse_entry  # noqa: E402


def control_numbers(cell, seed: int, device: str, workdir: str) -> dict:
    """The numbers compared when the cut reference stands in for the
    program on the genomes a run with ``seed`` would check."""
    cfg = cell.config
    p = reference.Params.from_dict(cell.settings)
    cut = cell.traffic["control_max_extend"]
    pool = genomes.make_pool(cfg, seed, workdir)
    sample = checked_genomes(seed, list(range(len(pool))),
                     cell.traffic["check_genomes"], len(pool))
    numbers = {k: 0 for k in check.LIMITS}
    for g in sample:
        parsed, parsed_y = parse_entry(pool[g])
        codes_y = None if parsed_y is None else parsed_y.codes
        want, _ = reference.compare(parsed.codes, p, device, codes_y=codes_y)
        got, _ = reference.compare(parsed.codes, p, device, max_extend=cut,
                                   codes_y=codes_y)
        files = report.render(want, parsed, p.min_family, cfg["mask"],
                              parsed_y)
        got_files = report.render(got, parsed, p.min_family, cfg["mask"],
                                  parsed_y)
        for k, v in check.compare([got], [got_files], want, files).items():
            numbers[k] += v
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="rkbench-control-") as d:
            numbers = control_numbers(cell, seed, device, d)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "numbers": numbers,
                          "correct": check.verdict(numbers),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
