"""A short run of a cell on the card, as the driver makes it: the result
line keeps to the contract. Skips where no CUDA device is visible."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ecoli_k12_self.ungapped", "--seed", str(2**31 + 3),
                          "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600,
                         cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    want = ({"fasta_read_s", "seeds_s", "device_idle_share", "k2_roofline"}
            if trace else {"throughput_mbp_s", "job_p95_s", "setup_s",
                           "device_peak_gib"})
    assert want <= set(res["metrics"])
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["k2_roofline"]["value"] <= 105
