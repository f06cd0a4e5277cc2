"""A helper rank with a fault planted, for the rank tests: the fault, from
the environment's RKBENCH_TEST_FAULT (JSON), applies to the rank it names
and to no other.

- ``{"rank": r, "kill_on_job": j}``: the rank kills itself (SIGKILL) as
  its j-th job starts;
- ``{"rank": r, "raise_in_clustering": true}``: the rank's family
  clustering raises, after every collective of the comparison and before
  the barrier of the writes;
- ``{"program": kind}``: every rank's timed path is broken alike
  (:func:`plant_program`; rank 0 plants it too).

Every rank takes ``control_timeout_s`` as its control timeout, where given.
"""

import json
import os
import signal
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent.parent)]

from harness import job as rk_job, ranks  # noqa: E402


def plant_program(kind: str) -> None:
    """A fault of the timed path, the same on every rank: ``unchanged``
    (every seed comes back unextended), ``half`` (half of each window's
    thinned seeds left out), ``exchange`` (the all-to-all between the
    ranks left out: each keeps its own blocks) or ``altered`` (one
    fragment's score altered where the merge produces it)."""
    from test_rkbench_faults import altered_score, half_seeds, unextended
    from repkiller_tpu_torch.chain import diagonal
    from repkiller_tpu_torch.dist import mesh, sharded

    if kind == "unchanged":
        diagonal.extend_dispatch = unextended
    elif kind == "half":
        sharded.filter_hits = half_seeds(sharded.filter_hits)
    elif kind == "exchange":
        mesh.ProcessMesh.all_to_all = lambda self, vals, axis: vals
    elif kind == "altered":
        sharded.merge_strands = altered_score(sharded.merge_strands)
    else:
        raise ValueError(kind)


def plant(fault: dict, rank: int) -> None:
    if "control_timeout_s" in fault:
        ranks.CONTROL_TIMEOUT_S = fault["control_timeout_s"]
    if "program" in fault:
        plant_program(fault["program"])
    if fault.get("rank") != rank:
        return
    if "kill_on_job" in fault:
        run, calls = rk_job.Job.run, [0]

        def killed(self, *args, **kwargs):
            calls[0] += 1
            if calls[0] == fault["kill_on_job"]:
                os.kill(os.getpid(), signal.SIGKILL)
            return run(self, *args, **kwargs)
        rk_job.Job.run = killed
    if fault.get("raise_in_clustering"):
        from repkiller_tpu_torch.dist import sharded

        def broken(*args, **kwargs):
            raise RuntimeError(f"clustering fails on rank {rank}")
        sharded.cluster_families = broken


if __name__ == "__main__":
    args = sys.argv[1:]
    plant(json.loads(os.environ["RKBENCH_TEST_FAULT"]),
          int(args[args.index("--rank") + 1]))
    raise SystemExit(ranks.helper_main(args))
