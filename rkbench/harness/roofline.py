"""Roofline arithmetic of the extension kernels, frozen here so that the
yardstick does not move with the program.

The work is what the job's inputs need, counted by the plain reference on
the same genome: for the banded Gotoh x-drop (kernel K1), every row each
extended seed's DP runs in each direction, times the W = 2 * band + 1
cells of a row, times 30 int32 operations a cell (adds, compares, selects
and maxes of the recurrence, the x-drop prune and the endpoint update);
for the ungapped x-drop (kernel K2), every step each extended seed
examines in each direction, times 12 int32 operations. The seeds are
those the semantics extend: the anchors and the seeds their anchors do
not cover. Bytes: each extended seed's two coordinates and flag read once
per direction, its outputs written once, and the two code arrays of the
comparison read once.

Peaks: the SMs' INT32 lanes (64 an SM) at the SM's maximum clock, and
the H100's 3.35 TB/s of HBM. A share is the least time those allow over
the kernels' measured device time.
"""

from __future__ import annotations

import subprocess

K1_OPS_PER_CELL = 30
K2_OPS_PER_STEP = 12
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
SEED_BYTES = 4 + 4 + 1         # px, py, flag
OUT_BYTES = {"banded": 5 * 4, "ungapped": 3 * 4}


def ops(mode: str, work: int, band: int) -> int:
    """int32 operations of ``work`` rows (banded) or steps (ungapped)."""
    if mode == "banded":
        return work * (2 * band + 1) * K1_OPS_PER_CELL
    return work * K2_OPS_PER_STEP


def nbytes(mode: str, seed_directions: int, genome_bp: int) -> int:
    return (seed_directions * (SEED_BYTES + OUT_BYTES[mode])
            + 2 * genome_bp)


def least_seconds(n_ops: float, n_bytes: float, int32_per_s: float) -> float:
    return max(n_ops / int32_per_s, n_bytes / HBM_BYTES_PER_S)


def smi(fields: str, index: int = 0) -> str:
    out = subprocess.run(["nvidia-smi", "-i", str(index),
                          f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def int32_per_s(sms: int, max_sm_mhz: float) -> float:
    return sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
