#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. build kernels K1 (csrc/banded_gotoh.cu) and K2 (csrc/ungapped_xdrop.cu)
     with nvcc, both at once; print each one's ptxas register and spill
     lines;
  2. K2 == its plain torch version (extend/ungapped.direction_plain),
     exactly, on random seeds at E = 64, 256 and 2048, x_drop 12 and 40,
     both directions; on the chunk-boundary cases of the tests (stops at
     steps 31-33 and 63-64, a best tied across step 32, seeds to E, scores
     1000/-3000, the drop switched off) and on one warp holding 5 seeds
     that run to E = 2048 among seeds that stop within 40 steps;
  3. K1 == its plain torch version (extend/banded.direction_plain),
     exactly, on random seeds at bands 4, 8, 15, 16 in the phase-1 shape
     (192 rows, jcap 192 + band) and the full shapes (512 and 2048 rows,
     jcap = rows), and at bands 31, 32, 47, 48 (the edges of 1, 2 and 3
     band cells per lane and of the wide kernel), 40 and 100 (100: rows
     wider than the warp kernel's 96 cells) in the phase-1 shape and at
     2048 rows; at bands 15, 31 and 47 with other scores, gaps and
     x_drops (K1_SCORES; at band 15 also scores at the edge of the warp
     kernel's keys), and at bands 15, 47 and 48 with scores past that
     edge (8000/-8000/1000/500), which run in the wide kernel;
  4. the golden 30 kb test: CSV and BED byte for byte through api.compare,
     and through ``python -m repkiller_tpu_torch.cli run``;
  5. the banded headline (bench.py's 4.19 Mbp synthetic genome, k=12,
     strands fr, banded): 139,287 fragments and hit totals
     [543009, 535532]; wall time and per-stage times of warm runs; device
     time by kernel and the device's idle share from torch.profiler; then
     K1 == the plain version on the headline's own seed sets (phase 1 over
     every seed, then the 2048-row pass over the seeds phase 1 left alive),
     K1's device time on each of those 8 sets, and on strand f's right-direction
     sets the plain version's time, the seed-rows the set needs (counted
     by the plain version) and K1's bound derived from them;
  6. the ungapped headline (the same genome, extend_mode "ungapped", the
     tool's default): 976 fragments, hit totals [543009, 535532], seeds
     [397907, 400603]; the same walls, stages and profile; then K2 == the
     plain version on every seed set the pipeline launched K2 with (both
     strands, both directions, anchor and survivor passes, device n_live),
     K2's device time on each of the 8 sets against its bound from the
     steps the set needs (counted by the plain version), and on the first
     set the plain version's time, the steps per seed, and K2's time with
     the seeds over 256 and over 32 steps cleared and at E = 32;
  7. the pairwise strain pair of benchmarks/run_config3.py at 4.6 Mbp
     (config #3) through api.compare, banded and ungapped: fragment
     counts, hit totals and seeds against the JAX package's records, walls,
     stage split and peak memory;
  8. staged execution with resume on the banded headline: device.compare
     with keep_intermediates equals the run without a store field for
     field; the rerun resumes from the stage files (no "seeds" or "extend"
     stage, no K1 launch) with the same output; walls without a store,
     staged and resumed;
  9. the streamed driver (dist/windows.compare_streamed) on the headline at
     window 2^20 (4 windows), banded and ungapped: equal to
     device.compare's output, window hit totals and seeds summing to the single-shot ones;
     then with out_dir, and a resume after the manifest's last two lines
     are dropped; walls with and without out_dir, per-window seeds and
     extend times, and the final merge; then K2 == the plain version on all
     32 of its window sets and K1 on window 0 strand f's 4 (phase 1 and
     the compacted re-run), and the device time of every window set;
 10. the streamed driver on config #3 with benchmarks/run_config3.py's
     streamed Config (hit capacity 2^21, seed capacity 2^19, window 2^20;
     5 windows), banded and ungapped: equal to phase 7's single-shot
     output; wall, device part and final merge;
 11. ``--stage-timing`` through the CLI on golden30k: the reference's JSONL
     records (stages and count fields);
 12. the sharded backend (dist/sharded.compare_sharded) on the headline,
     banded and ungapped, on one-process meshes of shapes (1, 1), (1, 2),
     (1, 4), (2, 1) and (2, 2) on the card: equal field for field to
     device.compare's output; K1 and K2 launches per shape. With two
     windows the headline's seed capacity of 2^19 is refused (the
     reference grants seed_capacity // n_data seeds a window, and a
     self-comparison's seeds crowd the first window, px < py): the
     refusal is printed and the run repeated at seed capacity 2^20;
 13. config #2 (benchmarks/run_config2.py: 12.1 Mbp self, k=16, banded,
     families) through device.compare: 5,735 fragments, 4,679 families, the
     largest of 178 fragments;
 14. config #4 (benchmarks/run_config4.py: two 24 Mbp records joined by an
     N, k=16, banded) through compare_sharded over make_mesh(), once on the
     one-process mesh and twice inside a one-rank NCCL process group (a
     process mesh, its collectives on the card; the first run also sets up
     NCCL's communicators): each 85,400 fragments,
     132,102 repeat intervals and 9,997,161 bp masked; wall, device part,
     clustering and peak memory; then K1 == the plain version on the
     phase-1 set of window 0, strand f;
 15. config #5 at 0.25x (benchmarks/run_config5.py: 62 Mbp, k=16, banded,
     hit capacity 2^21) through compare_sharded over make_mesh(): 140,486
     fragments;
 16. family clustering on the card (families/device.py) against the host
     path, on the output tables of the banded headline, config #3 banded,
     configs #2, #4 and #5 at 0.25x, and on the dense pileups of
     benchmarks/cluster_chip_bench.py at 6,600 and 19,000 loci x 32: the
     labels equal; fragments, edges before and after the ratio filter,
     rounds, the host path's seconds (median of 3), the device path's
     (median of 3 after a warm-up, labels on the host) and its peak device
     memory. Then device.compare on the banded headline with the default
     rule: the path it took, its edges and blocks, and its output, equal
     to phase 5's field for field and its labels to the host path's;
 17. the native host I/O (io/native.py, built with g++ in phase 1): config
     #4's 48 Mbp genome as a two-record FASTA through read_fasta (native)
     and the numpy parse, equal SeqSets; config #3's banded fragments
     through the native writer (to a file and to a stream) and the Python
     rows, equal bytes; both paths' times. Phase 4's CLI run writes its
     CSV with the native writer.

Before the card is pinned, ``nvidia-smi -L`` gives the machine's GPU
count, printed on an informational line. The counts of configs #2, #4 and
#5 are the JAX package's (BASELINE.md, round-5 campaign); as there, each
runs under utils/capacity.with_auto_capacity, and any grown capacity is
printed.

Every main-path run (5, 6, both runs of 7, those of 8-10 and 12-16) sets
the kernels' launch counts to 0 just before it and reads them just after.
A kernel's device time is taken with CUDA events around 20 launches that
the host queues while a ``torch.cuda._sleep`` holds the stream, so it
leaves out the host's pace. Informational lines come first; the last two lines are the kernels'
JSON record and the device's JSON record. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from repkiller_tpu_torch import api, device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist.mesh import ProcessMesh, make_mesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
from repkiller_tpu_torch.dist.windows import compare_streamed
from repkiller_tpu_torch.extend import _cuda, banded, ungapped
from repkiller_tpu_torch.families import cluster as tcluster, cluster_families
from repkiller_tpu_torch.io import fasta as tfasta, native
from repkiller_tpu_torch.report import csv_writer, intervals as report_iv
from repkiller_tpu_torch.table import family_stats, repeat_intervals
from repkiller_tpu_torch.utils import synth, trace
from repkiller_tpu_torch.utils.capacity import grow_capacity, with_auto_capacity
from repkiller_tpu_torch.utils.scan import partition_live

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_cuda import (ungapped_boundary_case,  # noqa: E402
                             ungapped_long_seeds_case)

GOLDEN = ROOT / "tests" / "golden"
GOLDEN_CFG = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=512,
                    extend_mode="banded", band=8)
GOLDEN_FLAGS = ["--k", "12", "--strands", "fr", "--hit-capacity", "16384",
                "--max-extend", "512", "--extend-mode", "banded", "--band", "8"]
# bench.py:71-78: the genome, families and Config of the headline workload
HEADLINE_SIZE = 1 << 22
HEADLINE_FAMS = [(1024, 6, 0.02, 2), (768, 5, 0.05, 1), (512, 7, 0.0, 0),
                 (1536, 3, 0.03, 1), (256, 8, 0.08, 2)]
HEADLINE_CFG = Config(k=12, strands="fr", extend_mode="banded",
                      hit_capacity=1 << 20, seed_capacity=1 << 19,
                      max_extend=2048)
UNGAPPED_CFG = HEADLINE_CFG.replace(extend_mode="ungapped")
# Expected outputs. Banded headline: BENCH_r05 (the JAX package on a TPU);
# seeding does not depend on the extend mode, so the hits and seeds are
# shared. Ungapped headline and config #3 ungapped: the JAX package on the
# CPU (JAX_PLATFORMS=cpu, repkiller_tpu.device.compare_staged on the same
# inputs). Config #3 banded: BASELINE.md:69,82 (the JAX package on a TPU).
HEADLINE_HITS = [543009, 535532]
HEADLINE_SEEDS = [397907, 400603]
HEADLINE_FRAGS = {"banded": 139287, "ungapped": 976}
# benchmarks/run_config3.py: the strain pair and Config of config #3
PAIR_SIZE, PAIR_SEED = 4_600_000, 77
PAIR_CFG = Config(k=12, strands="fr", extend_mode="banded",
                  hit_capacity=1 << 23, seed_capacity=1 << 21, max_extend=2048)
PAIR_HITS = [5357196, 1275396]
PAIR_SEEDS = [1101683, 957924]
PAIR_FRAGS = {"banded": 335570, "ungapped": 2290}
# benchmarks/run_config3.py's streamed Config: capacities per window
PAIR_STREAMED_CFG = Config(k=12, strands="fr", extend_mode="banded",
                           hit_capacity=1 << 21, seed_capacity=1 << 19,
                           max_extend=2048, window=1 << 20)
HEADLINE_WINDOW = 1 << 20
SHARDED_SHAPES = [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2)]
# benchmarks/run_config2.py, run_config4.py and run_config5.py: genomes
# (sizes, planted families, seeds) and Configs; expected counts from
# BASELINE.md's round-5 campaign (the JAX package on a TPU)
BIG_CFG = Config(k=16, strands="fr", extend_mode="banded", hit_capacity=1 << 20,
                 seed_capacity=1 << 19, max_extend=2048)
CONFIG2_SIZE, CONFIG2_SEED = 12_100_000, 4242
CONFIG2_FAMS = [(5900, 4, 0.03, 1), (332, 12, 0.05, 3), (137, 20, 0.08, 0),
                (1024, 6, 0.01, 2)]
CONFIG2_WANT = {"fragments": 5735, "families": 4679, "largest family": 178}
CONFIG4_SIZE, CONFIG4_SEEDS = 48_000_000, (21, 22)
CONFIG4_FAMS = [(7000, 5, 0.05, 2), (4100, 4, 0.08, 1), (359, 30, 0.06, 5),
                (1024, 8, 0.02, 2)]
CONFIG4_WANT = {"fragments": 85400, "repeat intervals": 132102,
                "masked bp": 9997161}
CONFIG5_SIZE, CONFIG5_SEED = int(248_000_000 * 0.25), 1
CONFIG5_FAMS = [(6000, 8, 0.10, 3), (300, 40, 0.12, 10), (1024, 10, 0.05, 3)]
CONFIG5_CFG = Config(k=16, strands="fr", extend_mode="banded",
                     hit_capacity=1 << 21, max_extend=2048)
CONFIG5_FRAGS = 140486
# utils/metrics.profile_stages' records: stage -> its count fields
STAGE_RECORDS = {"h2d": ["bp"], "index_build": ["kmers"], "seed_join": ["hits"],
                 "hit_filter": ["seeds"], "extension": ["seeds", "cells"],
                 "merge_accept": ["fragments"], "families_host": ["families"]}
PHASE1_ROWS = 192
# benchmarks/cluster_chip_bench.py's dense pileups: loci x 32 fragments;
# 6,600 loci gave 3,523,458 edges (BASELINE.md, TPU v5e round 5), 19,000
# loci about 10M, the tier the reference's record left open
PILEUP_LOCI = (6600, 19000)
# (match, mismatch, gap_open, gap_extend, x_drop) besides the defaults
K1_SCORES = [(4, -4, 8, 0, 40), (4, -4, 60, 2, 40), (1, -3, 5, 2, 20),
             (2, -7, 8, 1, 25), (4, -4, 8, 2, 2**31 - 1), (4, -4, 8, 2, -3)]
# (match, mismatch, x_drop) of K2's chunk-boundary cases
K2_SCORES = [(4, -4, 20), (1000, -3000, 15000), (4, -4, 2**31 - 1),
             (1000, -3000, 2**31 - 1)]
SLEEP_CYCLES = 200_000_000  # about 0.1 s at the H100's 1.98 GHz
# Bounds. K1 does about 30 int32 operations (adds, compares, selects,
# maxes) per band cell per row a seed runs, K2 about 12 per step; both run
# on the SMs' INT32 lanes, 64 per SM per clock. Bytes: each input read
# once and each output written once, at the H100's 3.35 TB/s.
K1_OPS_PER_CELL = 30
K2_OPS_PER_STEP = 12
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def machine_gpu_count():
    """The machine's GPU count from ``nvidia-smi -L`` (NVML, which
    CUDA_VISIBLE_DEVICES does not restrict; CUDA is not initialised), or
    None where nvidia-smi does not run."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode:
        return None
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


def pin_one_card() -> str:
    """Make the first visible card the only one CUDA sees (before CUDA is
    initialised), so the run uses, and reports, exactly one device."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def smi_query(gpu: str, fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", gpu, f"--query-gpu={fields}",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card(gpu: str) -> str:
    return smi_query(gpu, "name,power.limit")


def int32_rate(gpu: str) -> float:
    """Peak int32 operations per second: SMs x 64 INT32 lanes x the SM's
    maximum clock as nvidia-smi reports it."""
    mhz = float(smi_query(gpu, "clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound(ops: float, nbytes: float, rate: float):
    """(least time in ms, what sets it) for ``ops`` int32 operations and
    ``nbytes`` bytes moved."""
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def io_bytes(inputs, n_live, n_outputs: int) -> int:
    """Bytes a kernel must move: px, py and valid read once for the slots
    below n_live (the kernels read no seed at or past it), each distinct
    code array read once (a self-comparison passes one tensor as cx and
    cy), and n_outputs int32 outputs written once for every slot."""
    px, py, valid, cx, cy = inputs
    m = min(px.shape[0], int(n_live))
    seeds = m * (px.element_size() + py.element_size() + valid.element_size())
    codes = {t.data_ptr(): t.numel() * t.element_size() for t in (cx, cy)}
    return seeds + sum(codes.values()) + n_outputs * 4 * px.shape[0]


def make_strain_pair(size: int, seed: int):
    """benchmarks/run_config3.py's generator, copied: strain B is strain A
    with 1% SNPs, a segment swap and a 5 kb insertion."""
    g = synth.plant(size, [(1024, 5, 0.02, 1), (512, 6, 0.0, 2)], seed=seed)
    a = g.codes
    rng = np.random.default_rng(seed + 1)
    b = a.copy()
    snp = rng.random(b.shape[0]) < 0.01
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    q = size // 4
    b = np.concatenate([b[q : 2 * q], b[:q], b[2 * q :]])
    ins = rng.integers(0, 4, 5000).astype(np.uint8)
    b = np.concatenate([b[: size // 2], ins, b[size // 2 :]])
    return a, b


LAUNCH_COUNTERS = {"banded": "k1_launches", "ungapped": "k2_launches"}
_launch_base = {}


def reset_launches() -> None:
    totals = trace.totals()
    _launch_base.update({mode: totals.get(c, 0)
                         for mode, c in LAUNCH_COUNTERS.items()})


def launches() -> dict:
    """Each kernel's launches since reset_launches, from the trace."""
    totals = trace.totals()
    return {mode: totals.get(c, 0) - _launch_base.get(mode, 0)
            for mode, c in LAUNCH_COUNTERS.items()}


def kernel_args(cfg: Config, E: int, jcap: int, base_off: int, step: int):
    return (base_off, step, cfg.match, cfg.mismatch, cfg.x_drop, E, cfg.band,
            cfg.gap_open, cfg.gap_extend, jcap)


def compare_kernel(kernel, plain, inputs, args, n_live):
    """Run a kernel and its plain version on the same inputs -> (max
    |diff|, the kernel's outputs)."""
    got = kernel(*inputs, *args, n_live)
    want = plain(*inputs, *args, n_live)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if err:
        bad = torch.nonzero(torch.stack(got) != torch.stack(want))[:5].tolist()
        raise RuntimeError(f"{kernel.__name__} != plain for args {args}: max "
                           f"|diff| {err}, first (output, seed) pairs {bad}")
    return err, got


def compare_k1(inputs, args, n_live):
    return compare_kernel(_cuda.banded_gotoh, banded.direction_plain, inputs,
                          args, n_live)


def compare_k2(inputs, args, n_live):
    return compare_kernel(_cuda.ungapped_xdrop, ungapped.direction_plain,
                          inputs, args, n_live)


def random_case(seed: int, n: int, L: int, dev):
    """Mutated, shifted copies with N blocks; seeds near the ends; invalid
    slots in front and every slot from n_live on."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.03
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    for s in rng.integers(0, L, 40):
        cy[s:] = np.roll(cy[s:], int(rng.integers(-2, 3)))
    for s in rng.integers(0, L - 20, 30):
        (cx if s % 2 else cy)[s:s + int(rng.integers(1, 12))] = 4
    px = rng.integers(0, L - 12, n).astype(np.int32)
    py = np.clip(px + rng.integers(-3, 4, n), 0, L - 12).astype(np.int32)
    px[:4] = py[:4] = [0, 3, L - 12, L - 40]
    n_live = n - 37
    valid = rng.random(n) > 0.02
    valid[n_live:] = False
    t = [torch.from_numpy(a).to(dev) for a in (px, py, valid, cx, cy)]
    return t, n_live


def phase_build():
    t0 = time.perf_counter()
    libs = _cuda.build(_cuda.BANDED_SOURCE, _cuda.UNGAPPED_SOURCE)
    print(f"# build: {', '.join(so.name for so in libs)} in "
          f"{time.perf_counter() - t0:.3f} s (one nvcc each, together)")
    t0 = time.perf_counter()
    check(native.available(), "the native I/O library did not build")
    print(f"# build: {native.library_path(native.SOURCE).name} (g++) in "
          f"{time.perf_counter() - t0:.3f} s")
    for so in libs:
        log = Path(f"{so}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"#   {so.name.split('-')[0]} ptxas: {line.strip()}")


def phase_k2_vs_plain(dev) -> int:
    worst = 0
    for x_drop in (12, 40):
        cfg = UNGAPPED_CFG.replace(x_drop=x_drop)
        inputs, n_live = random_case(100 + x_drop, 4096, 60000, dev)
        for E in (64, 256, 2048):
            for base_off, step in ((cfg.k, +1), (-1, -1)):
                args = (base_off, step, cfg.match, cfg.mismatch, x_drop, E)
                err, got = compare_k2(inputs, args, n_live)
                worst = max(worst, err)
                print(f"# K2 == plain: x_drop {x_drop} E {E} step {step:+d}: "
                      f"exact ({int((got[0] == E).sum())} seeds at the cap, "
                      f"longest {int(got[0].max())})")
    k = UNGAPPED_CFG.k
    for step in (+1, -1):
        base_off = k if step > 0 else -1
        for m, mm, x_drop in K2_SCORES:
            *case, n_live = ungapped_boundary_case(step, k, m, mm, 5)
            inputs = [torch.from_numpy(a).to(dev) for a in case]
            err, got = compare_k2(inputs, (base_off, step, m, mm, x_drop, 128),
                                  n_live)
            worst = max(worst, err)
            print(f"# K2 == plain on the chunk boundaries: scores {m} {mm} "
                  f"x_drop {x_drop} step {step:+d}: exact (ext "
                  f"{got[0][:n_live].tolist()})")
        *case, long = ungapped_long_seeds_case(step, k)
        inputs = [torch.from_numpy(a).to(dev) for a in case]
        err, got = compare_k2(inputs, (base_off, step, 4, -4, 4, 2048), 32)
        worst = max(worst, err)
        check(bool((got[0][torch.from_numpy(long).to(dev)] == 2048).all()),
              "a long seed of the one-warp case stopped early")
        print(f"# K2 == plain on one warp with 5 seeds to E = 2048, step "
              f"{step:+d}: exact (ext {got[0].tolist()})")
    return worst


def phase_k1_vs_plain(dev) -> int:
    worst = 0
    shapes = {b: ((PHASE1_ROWS, PHASE1_ROWS + b), (512, 512), (2048, 2048))
              for b in (4, 8, 15, 16)}
    shapes.update({b: ((PHASE1_ROWS, PHASE1_ROWS + b), (2048, 2048))
                   for b in (31, 32, 47, 48, 40, 100)})
    for band, cases in shapes.items():
        cfg = HEADLINE_CFG.replace(band=band)
        inputs, n_live = random_case(band, 4096, 60000, dev)
        for E, jcap in cases:
            for base_off, step in ((cfg.k, +1), (-1, -1)):
                args = kernel_args(cfg, E, jcap, base_off, step)
                err, got = compare_k1(inputs, args, n_live)
                worst = max(worst, err)
                print(f"# K1 == plain: band {band} E {E} jcap {jcap} "
                      f"step {step:+d}: exact ({int(got[4].sum())} alive "
                      "at the cap)")
    # other scores in the phase-1 shape: gap_extend 0 (the scan's ties), a
    # large gap_open, match != -mismatch, the drop switched off, a negative
    # x_drop, and scores at the edge of the warp kernel's keys (band 15)
    for band in (15, 31, 47):
        inputs, n_live = random_case(200 + band, 4096, 60000, dev)
        for m, mm, go, ge, xd in K1_SCORES + (
                [(4000, -4000, 1000, 500, 2**31 - 1)] if band == 15 else []):
            cfg = HEADLINE_CFG.replace(band=band, match=m, mismatch=mm,
                                       gap_open=go, gap_extend=ge, x_drop=xd)
            for base_off, step in ((cfg.k, +1), (-1, -1)):
                args = kernel_args(cfg, PHASE1_ROWS, PHASE1_ROWS + band,
                                   base_off, step)
                err, got = compare_k1(inputs, args, n_live)
                worst = max(worst, err)
            print(f"# K1 == plain: band {band} scores {m} {mm} {go} {ge} "
                  f"x_drop {xd}, both directions: exact ({int(got[4].sum())}"
                  " alive at the cap)")
    # scores past the warp kernel's keys: the wide kernel takes them
    lib = _cuda._lib(_cuda.BANDED_SOURCE)
    for band in (15, 47, 48):
        inputs, n_live = random_case(300 + band, 4096, 60000, dev)
        cfg = HEADLINE_CFG.replace(band=band, match=8000, mismatch=-8000,
                                   gap_open=1000, gap_extend=500)
        wide = lib.rk_banded_needs_scratch(band, cfg.match, cfg.mismatch,
                                           PHASE1_ROWS, cfg.gap_open,
                                           cfg.gap_extend)
        check(wide == 1, f"band {band}, scores 8000/-8000: not the wide kernel")
        for base_off, step in ((cfg.k, +1), (-1, -1)):
            args = kernel_args(cfg, PHASE1_ROWS, PHASE1_ROWS + band, base_off,
                               step)
            err, got = compare_k1(inputs, args, n_live)
            worst = max(worst, err)
        print(f"# K1 == plain past the warp kernel's keys: band {band} scores "
              f"8000 -8000 1000 500, both directions: exact in the wide "
              f"kernel ({int(got[4].sum())} alive at the cap)")
    return worst


def phase_golden():
    res = api.compare(str(GOLDEN / "golden30k.fasta"), cfg=GOLDEN_CFG,
                      device="cuda")
    buf = io.StringIO()
    res.write_csv(buf)
    check(buf.getvalue() == (GOLDEN / "golden30k.frags.csv").read_text(),
          "golden CSV differs")
    buf = io.StringIO()
    res.write_intervals(buf)
    check(buf.getvalue() == (GOLDEN / "golden30k.repeats.bed").read_text(),
          "golden BED differs")
    print(f"# golden30k: CSV and BED byte-identical ({res.n_fragments} "
          f"fragments, {res.n_families} families)")


def phase_cli():
    """The CLI in its own process on the card; its CSV and BED against the
    golden files."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "golden30k")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repkiller_tpu_torch.cli", "run",
             str(GOLDEN / "golden30k.fasta"), "-o", prefix, "--device", "cuda",
             *GOLDEN_FLAGS], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"the CLI failed: {proc.stderr[-2000:]}")
        for suffix in (".frags.csv", ".repeats.bed"):
            check(Path(prefix + suffix).read_bytes()
                  == (GOLDEN / f"golden30k{suffix}").read_bytes(),
                  f"the CLI's {suffix} differs from the golden file")
        metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"# CLI run on the card: golden CSV (native writer: "
          f"{native.available()}) and BED byte-identical; "
          f"{metrics['fragments']} fragments, process wall "
          f"{time.perf_counter() - t0:.3f} s")


def phase_headline(codes: np.ndarray, cx: torch.Tensor, cfg: Config, smi: str):
    """Device-side counts against the records, then three warm runs through
    device.compare, the third one counted -> that run's launch counts."""
    mode = cfg.extend_mode
    t0 = time.perf_counter()
    out, n_frags, totals, n_seeds = tdevice.compare_staged(cx, None, cfg)
    torch.cuda.synchronize()
    print(f"# {mode} headline first run (device part, incl. load): "
          f"{time.perf_counter() - t0:.3f} s")
    check(int(n_frags) == HEADLINE_FRAGS[mode],
          f"{mode} headline fragments {int(n_frags)} != {HEADLINE_FRAGS[mode]}")
    check(totals.tolist() == HEADLINE_HITS,
          f"{mode} headline hit totals {totals.tolist()} != {HEADLINE_HITS}")
    check(n_seeds.tolist() == HEADLINE_SEEDS,
          f"{mode} headline seeds {n_seeds.tolist()} != {HEADLINE_SEEDS}")
    print(f"# {mode} headline: {int(n_frags)} fragments, hit totals "
          f"{totals.tolist()}, seeds {n_seeds.tolist()}")

    walls, stages = [], []
    for r in range(3):
        if r == 2:
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        frag = tdevice.compare(codes, None, cfg, "cuda", timings=timings)
        walls.append(time.perf_counter() - t0)
        stages.append(timings)
        n = HEADLINE_FRAGS[mode]
        check(frag["xStart"].shape[0] == n,
              f"{mode} headline fragments {frag['xStart'].shape[0]}")
        check(all(np.isfinite(v).all() and v.shape == (n,)
                  for v in frag.values()), f"{mode} headline output malformed")
    counted = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"# {mode} headline warm walls (s): {[round(w, 6) for w in walls]}, "
          f"median {statistics.median(walls):.6f} s on {smi}")
    for name in stages[0]:
        vals = [s[name] for s in stages]
        print(f"#   stage {name}: {[round(v, 6) for v in vals]} s")
    print(f"#   clustering of the output, timed apart: "
          f"{clustering(frag, cfg, True):.6f} s")
    print(f"# {mode} headline peak device memory {peak:.3f} GiB; launches in "
          f"the counted run: {counted}; families {len(np.unique(frag['group']))}")
    return counted, frag


def clustering(frag: dict, cfg: Config, self_cmp: bool) -> float:
    """Seconds of the family clustering of an output table on the card's
    default path, which device.compare and compare_sharded run last; it
    must give the same families."""
    t0 = time.perf_counter()
    group = cluster_families({f: v for f, v in frag.items() if f != "group"},
                             cfg, self_cmp)
    dt = time.perf_counter() - t0
    check(np.array_equal(group, frag["group"]), "clustering differs")
    return dt


def phase_profile(cx: torch.Tensor, cfg: Config, smi: str):
    """Device time by kernel name and the device's idle share over one
    profiled run of the device part (clustering excluded); profiling
    adds host overhead, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tdevice.compare_staged(cx, None, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no device activity")
    print(f"# {cfg.extend_mode} profiled device part: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle "
          f"share {1 - busy_us / wall_us:.4f} on {smi}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"#   {us / 1e3:9.3f} ms  {name[:100]}")
    for name, us in by_name.items():
        if "gotoh" in name or "xdrop" in name:
            n = sum(1 for e in prof.events() if e.name == name
                    and str(e.device_type).endswith("CUDA"))
            print(f"#   kernel {name[:60]}: {us / 1e3:.3f} ms in {n} launches")


def time_cuda(fn, reps: int) -> float:
    """ms per call between CUDA events around ``reps`` calls, at the
    host's pace: for the plain versions, which wait on the device."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_device(fn, reps: int = 20) -> float:
    """Device ms per launch of a kernel's wrapper: the host queues the
    events and ``reps`` launches while ``torch.cuda._sleep`` holds the
    stream, so the launches run back to back; fails if the sleep ended
    before the host had queued them all."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    check(not a.query(), "the device reached the timed launches before the "
          "host had queued them: raise SLEEP_CYCLES")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_k1_headline_sets(cx: torch.Tensor, smi: str, rate: float):
    """K1 == the plain version on the banded headline's own seed sets, for
    both strands and both directions: phase 1 (192 rows, jcap 192 + band)
    over every seed, then the full-depth pass (max_extend rows, jcap
    max_extend) over the seeds phase 1 left alive, compacted to the front
    with a device ``n_live`` as the pipeline's re-run has them. That set
    holds the re-run's own, which also drops the seeds their anchor
    covers. Times K1 on all 8 sets; on strand f, right direction, also the
    plain version, the seed-rows each pass needs and K1's bound ->
    (worst error, phase-1 ms, plain ms, bound ms, bound_by)."""
    cfg = HEADLINE_CFG
    W = 2 * cfg.band + 1
    worst, sets = 0, []
    for strand, (spx, spy, sv, n_seeds, _) in tdevice.self_seeds_fn(cx, cfg).items():
        cy = cx if strand == 0 else tdevice.revcomp_device(cx)
        for base_off, step in ((cfg.k, +1), (-1, -1)):
            p1 = ((spx, spy, sv, cx, cy),
                  kernel_args(cfg, PHASE1_ROWS, PHASE1_ROWS + cfg.band,
                              base_off, step), n_seeds)
            err1, got = compare_k1(*p1)
            need = sv & (got[4] == 1)
            order, _, n2 = partition_live(need)
            p2 = ((spx[order], spy[order], need[order], cx, cy),
                  kernel_args(cfg, cfg.max_extend, cfg.max_extend, base_off,
                              step), n2)
            err2, got2 = compare_k1(*p2)
            worst = max(worst, err1, err2)
            name = f"strand {'fr'[strand]} step {step:+d}"
            print(f"# K1 == plain on the headline: {name}: phase 1 exact "
                  f"({int(n_seeds)} live seeds of {spx.shape[0]}), full depth "
                  f"exact ({int(n2)} re-run seeds, {int(got2[4].sum())} alive "
                  f"at row {cfg.max_extend})")
            sets += [(name, "phase 1", p1), (name, "full depth", p2)]
    total, times = {"phase 1": 0.0, "full depth": 0.0}, []
    for name, kind, (inp, args, nl) in sets:
        times.append(time_device(lambda: _cuda.banded_gotoh(*inp, *args, nl)))
        total[kind] += times[-1]
        print(f"# K1 on the headline, {name}, {kind}: {times[-1]:.6f} ms")
    print(f"# K1 on the headline's 8 sets: phase 1 {total['phase 1']:.6f} ms, "
          f"full depth {total['full depth']:.6f} ms in all on {smi}")
    timed = []
    for (name, kind, (inp, args, nl)), ms in zip(sets[:2], times):  # f, +1
        plain_ms = time_cuda(lambda: banded.direction_plain(*inp, *args, nl), 2)
        rows = banded.direction_plain(*inp, *args, nl, live_rows=True)[5]
        seed_rows = int(rows.sum())
        ops = seed_rows * W * K1_OPS_PER_CELL
        nbytes = io_bytes(inp, nl, 5)
        bound_ms, by = bound(ops, nbytes, rate)
        print(f"# K1 on the headline, {name}, {kind}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms; {seed_rows} seed-rows over "
              f"{rows.numel()} rows x W {W} x {K1_OPS_PER_CELL} int32 ops = "
              f"{ops} ops at {rate / 1e12:.4f} T op/s; {nbytes} bytes; bound "
              f"{bound_ms:.6f} ms ({by}), roofline share {bound_ms / ms:.4f} "
              f"on {smi}")
        timed.append((ms, plain_ms, bound_ms, by))
    (ms, plain_ms, bound_ms, by), _ = timed
    return worst, ms, plain_ms, bound_ms, by


def record_launches(name: str, run):
    """Call ``run()`` with the kernel wrapper ``_cuda.<name>`` recording its
    arguments -> (the wrapper, the recorded argument tuples)."""
    kernel = getattr(_cuda, name)
    recorded = []

    def recording(*args):
        recorded.append(args)
        return kernel(*args)

    setattr(_cuda, name, recording)
    try:
        run()
    finally:
        setattr(_cuda, name, kernel)
    return kernel, recorded


def phase_k2_headline_sets(cx: torch.Tensor, smi: str, rate: float):
    """K2 == the plain version on every seed set the ungapped headline
    launches K2 with: the pipeline runs once with the kernel's wrapper
    recording its arguments (both strands; right and left; the compacted
    anchor pass and survivor pass, each with a device ``n_live``), then
    each recorded launch is held against the plain version. Times K2 on
    every set, with its bound from the steps the set needs, and the plain
    version on the first set (strand f, anchors, right) -> that set's
    (worst error over all, ms, plain ms, bound ms, bound_by)."""
    kernel, recorded = record_launches(
        "ungapped_xdrop", lambda: tdevice.compare_staged(cx, None, UNGAPPED_CFG))
    check(len(recorded) == 8, f"{len(recorded)} K2 launches, expected 8: 2 "
          "strands x (anchors, survivors) x 2 directions")
    worst = 0
    for i, args in enumerate(recorded):
        inputs, rest, n_live = args[:5], args[5:-1], args[-1]
        check(torch.is_tensor(n_live) and n_live.is_cuda,
              "the pipeline passed K2 a host n_live")
        err, got = compare_k2(inputs, rest, n_live)
        worst = max(worst, err)
        print(f"# K2 == plain on the ungapped headline, launch {i} (strand "
              f"{'fr'[i // 4]}, {('anchors', 'survivors')[i // 2 % 2]}, step "
              f"{rest[1]:+d}): exact ({int(n_live)} live of {inputs[0].shape[0]}"
              f", longest {int(got[0].max())})")
    timed = []
    for i, args in enumerate(recorded):
        ms = time_device(lambda: kernel(*args))
        per_seed = ungapped.direction_plain(*args, count_steps=True)[3]
        steps = int(per_seed.sum(dtype=torch.int64))
        if i == 0:
            steps0 = per_seed
        ops = steps * K2_OPS_PER_STEP
        nbytes = io_bytes(args[:5], args[-1], 3)
        bound_ms, by = bound(ops, nbytes, rate)
        print(f"# K2 on the ungapped headline, launch {i} ({int(args[-1])} "
              f"live of {args[0].shape[0]}): kernel {ms:.6f} ms; {steps} steps "
              f"x {K2_OPS_PER_STEP} int32 ops = {ops} ops at {rate / 1e12:.4f} "
              f"T op/s; {nbytes} bytes; bound {bound_ms:.6f} ms ({by}), "
              f"roofline share {bound_ms / ms:.4f} on {smi}")
        timed.append((ms, bound_ms, by))
    print(f"# K2 on the headline's 8 sets: {sum(t[0] for t in timed):.6f} ms "
          f"in all on {smi}")
    # launch 0's steps per seed, and K2 without its longest seeds and over
    # its first 32 steps only: what the tail, Phase B and Phase A cost
    args = recorded[0]
    live = args[2][:int(args[-1])]
    st = steps0[:int(args[-1])][live]
    p50, p99 = torch.quantile(st.float(), torch.tensor([0.5, 0.99], device=st.device)).tolist()
    print(f"# K2 launch 0 steps per seed: {st.numel()} seeds, mean "
          f"{st.float().mean().item():.2f}, p50 {p50:.0f}, p99 {p99:.0f}, max "
          f"{int(st.max())}; {int((st > 32).sum())} over 32 steps "
          f"({int(st[st > 32].sum())} steps), {int((st > 256).sum())} over 256")
    for cut in (256, 32):
        short = args[:2] + (args[2] & (steps0 <= cut),) + args[3:]
        print(f"# K2 on launch 0 with the seeds over {cut} steps cleared: "
              f"{time_device(lambda: kernel(*short)):.6f} ms on {smi}")
    first32 = args[:10] + (32,) + args[11:]
    print(f"# K2 on launch 0 at E = 32 (Phase A alone): "
          f"{time_device(lambda: kernel(*first32)):.6f} ms on {smi}")
    plain_ms = time_cuda(lambda: ungapped.direction_plain(*args), 3)
    ms, bound_ms, by = timed[0]
    print(f"# K2 on the ungapped headline, strand f, anchors, right "
          f"direction: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms")
    return worst, ms, plain_ms, bound_ms, by


def phase_pairwise(smi: str) -> dict:
    """Config #3 at full width: the device part once for its counts and
    stage split, then api.compare (clustering included) for the
    output and the end-to-end wall, with launches counted -> (the counted
    launches per mode, the output per mode)."""
    t0 = time.perf_counter()
    a, b = make_strain_pair(PAIR_SIZE, PAIR_SEED)
    print(f"# config #3 strain pair: {a.shape[0]} + {b.shape[0]} bp, made in "
          f"{time.perf_counter() - t0:.3f} s")
    ca = torch.from_numpy(a.copy()).cuda()
    cb = torch.from_numpy(b.copy()).cuda()
    counted, frags = {}, {}
    for mode in ("banded", "ungapped"):
        cfg = PAIR_CFG.replace(extend_mode=mode)
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, n_frags, totals, n_seeds = tdevice.compare_staged(ca, cb, cfg, timings)
        dev_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(totals.tolist() == PAIR_HITS,
              f"config #3 {mode} hit totals {totals.tolist()} != {PAIR_HITS}")
        check(n_seeds.tolist() == PAIR_SEEDS,
              f"config #3 {mode} seeds {n_seeds.tolist()} != {PAIR_SEEDS}")
        check(int(n_frags) == PAIR_FRAGS[mode],
              f"config #3 {mode} fragments {int(n_frags)} != {PAIR_FRAGS[mode]}")
        reset_launches()
        t0 = time.perf_counter()
        res = api.compare(a, b, cfg, device="cuda")
        wall = time.perf_counter() - t0
        counted[mode] = launches()
        frags[mode] = res.frag
        check(counted[mode][mode] > 0, f"config #3 {mode} launched no kernel")
        check(res.n_fragments == PAIR_FRAGS[mode] and all(
            np.isfinite(v).all() and v.shape == (res.n_fragments,)
            for v in res.frag.values()), f"config #3 {mode} output malformed")
        print(f"# config #3 {mode}: {res.n_fragments} fragments, "
              f"{res.n_families} families, hit totals {totals.tolist()}, "
              f"seeds {n_seeds.tolist()}")
        print(f"#   device part {dev_wall:.6f} s (first run, stages "
              f"{ {k: round(v, 6) for k, v in timings.items()} }), "
              f"api.compare wall {wall:.6f} s, peak device memory "
              f"{peak:.3f} GiB, launches {counted[mode]} on {smi}")
    return counted, frags


def check_same(got: dict, want: dict, what: str) -> None:
    """Field for field equality of two fragment tables, group included."""
    check(got.keys() == want.keys(), f"{what}: fields {sorted(got)}")
    for f in want:
        check(got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]),
              f"{what}: field {f} differs from the single-shot output")


def phase_staged(codes: np.ndarray, single: dict, smi: str) -> dict:
    """The banded headline through device.compare with keep_intermediates:
    the staged run, then its resume from the stage files; both equal the
    run without a store -> the staged run's launch counts."""
    cfg = HEADLINE_CFG
    t0 = time.perf_counter()
    tdevice.compare(codes, None, cfg, "cuda")
    plain_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        walls, stages, counted = [], [], []
        for run in ("staged", "resumed"):
            timings = {}
            reset_launches()
            t0 = time.perf_counter()
            frag = tdevice.compare(codes, None, cfg, "cuda", timings=timings,
                                   keep_intermediates=tmp)
            walls.append(time.perf_counter() - t0)
            counted.append(launches())
            stages.append(timings)
            check_same(frag, single, f"{run} banded headline")
        nbytes = sum(p.stat().st_size for p in Path(tmp).iterdir())
    check(frag["xStart"].shape[0] == HEADLINE_FRAGS["banded"],
          "staged headline fragments")
    check(counted[0]["banded"] > 0, f"the staged run launched {counted[0]}")
    check(counted[1]["banded"] == 0 and not {"seeds", "extend"} & set(stages[1]),
          f"the resume ran {stages[1]} and launched {counted[1]}")
    print(f"# staged banded headline: {frag['xStart'].shape[0]} fragments, "
          f"equal to the run without a store; walls: without a store "
          f"{plain_wall:.6f} s, staged "
          f"{walls[0]:.6f} s, resumed {walls[1]:.6f} s on {smi}")
    for run, timings, c in zip(("staged", "resumed"), stages, counted):
        print(f"#   {run} stages { {k: round(v, 6) for k, v in timings.items()} }"
              f", launches {c}")
    print(f"#   stage files: {nbytes} bytes")
    return counted[0]


def streamed_run(x, y, cfg, what: str, want: dict, smi: str, **kw):
    """compare_streamed with launches counted and per-stage stats; its
    output against ``want`` -> (wall, stats, launches)."""
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    frag = compare_streamed(x, y, cfg, device="cuda", stats=stats, **kw)
    wall = time.perf_counter() - t0
    counted = launches()
    check_same(frag, want, what)
    n_blocks = stats["windows"] * len(cfg.strands)
    print(f"# {what}: {frag['xStart'].shape[0]} fragments, equal to the "
          f"single-shot output; wall {wall:.6f} s on {smi}; {stats['windows']} "
          f"windows, hit totals {stats['hit_totals']}, seeds "
          f"{stats['seed_counts']}, launches {counted}")
    per = {k: round(stats[k], 6) for k in ("index", "seeds", "extend", "io",
                                           "merge", "families") if k in stats}
    print(f"#   stages (s) {per}; per window and strand: seeds "
          f"{stats['seeds'] / n_blocks:.6f}, extend "
          f"{stats['extend'] / n_blocks:.6f} s")
    return wall, stats, counted


def phase_streamed_headline(codes: np.ndarray, single: dict, smi: str) -> dict:
    """compare_streamed on the headline at window 2^20, both modes: in
    memory, then with out_dir, then resumed after the manifest's last two
    lines are dropped -> the in-memory runs' launch counts per mode."""
    counted = {}
    for mode in ("banded", "ungapped"):
        cfg = HEADLINE_CFG.replace(extend_mode=mode)
        what = f"streamed {mode} headline"
        _, stats, counted[mode] = streamed_run(
            codes, None, cfg, what, single[mode], smi, window=HEADLINE_WINDOW)
        check(stats["windows"] == 4, f"{what}: {stats['windows']} windows")
        check(stats["hit_totals"] == HEADLINE_HITS
              and stats["seed_counts"] == HEADLINE_SEEDS,
              f"{what}: window sums {stats['hit_totals']} "
              f"{stats['seed_counts']} != the single-shot totals")
        check(counted[mode][mode] > 0, f"{what} launched {counted[mode]}")
        with tempfile.TemporaryDirectory() as tmp:
            streamed_run(codes, None, cfg, what + " with out_dir", single[mode],
                         smi, window=HEADLINE_WINDOW, out_dir=tmp)
            manifest = Path(tmp) / "manifest.jsonl"
            lines = manifest.read_text().splitlines()
            manifest.write_text("\n".join(lines[:-2]) + "\n")
            _, stats, c = streamed_run(
                codes, None, cfg, what + " resumed (2 windows dropped)",
                single[mode], smi, window=HEADLINE_WINDOW, out_dir=tmp)
            check(len(manifest.read_text().splitlines()) == len(lines) == 8,
                  f"{what}: the manifest was not restored")
            check(c[mode] > 0 and stats["hit_totals"][0] == 0,
                  f"{what}: the resume recomputed {stats['hit_totals']}")
    check(counted["ungapped"]["banded"] == 0,
          "the streamed ungapped headline launched K1")
    return counted


def phase_window_sets(codes: np.ndarray, smi: str) -> None:
    """The kernels' launches inside the streamed headline's windows, each
    window's seed set at 2^19 slots with a device n_live far below: K2's
    32 launches (4 windows x 2 strands x anchors and survivors x 2
    directions) all held against the plain version and timed; K1's 32 all
    timed, and window 0 strand f's four (phase 1 and the compacted
    full-depth re-run of its survivors, both directions) held against
    the plain version, which takes seconds a set."""
    for mode, name, compare in (("ungapped", "ungapped_xdrop", compare_k2),
                                ("banded", "banded_gotoh", compare_k1)):
        cfg = HEADLINE_CFG.replace(extend_mode=mode)
        kernel, recorded = record_launches(name, lambda: compare_streamed(
            codes, None, cfg, window=HEADLINE_WINDOW, device="cuda"))
        check(len(recorded) == 32, f"{len(recorded)} {name} launches in the "
              "streamed headline, expected 32")
        held = recorded if mode == "ungapped" else recorded[:4]
        for args in held:
            check(torch.is_tensor(args[-1]) and args[-1].is_cuda,
                  f"the streamed driver passed {name} a host n_live")
            compare(args[:5], args[5:-1], args[-1])
        kinds = {}
        for i, args in enumerate(recorded):
            ms = time_device(lambda: kernel(*args))
            if mode == "ungapped":
                kind = ("anchors", "survivors")[i // 2 % 2]
            else:
                kind = "phase 1" if args[10] == PHASE1_ROWS else "full depth"
            kinds.setdefault(kind, []).append((int(args[-1]), ms))
        for kind, sets in kinds.items():
            live = [n for n, _ in sets]
            ms = sorted(t for _, t in sets)
            print(f"# {name} on the streamed headline's window sets, {kind}: "
                  f"{len(sets)} launches, live seeds {min(live)}-{max(live)} of "
                  f"{recorded[0][0].shape[0]}; device time min {ms[0]:.6f}, "
                  f"median {statistics.median(ms):.6f}, max {ms[-1]:.6f}, "
                  f"sum {sum(ms):.6f} ms on {smi}")
        print(f"# {name} == plain on {len(held)} window sets (exact)")


def phase_streamed_pair(a: np.ndarray, b: np.ndarray, single: dict,
                        smi: str) -> dict:
    """compare_streamed on config #3 with run_config3.py's streamed Config,
    both modes, against phase 7's single-shot outputs -> launch counts."""
    counted = {}
    for mode in ("banded", "ungapped"):
        cfg = PAIR_STREAMED_CFG.replace(extend_mode=mode)
        what = f"streamed config #3 {mode}"
        wall, stats, counted[mode] = streamed_run(a, b, cfg, what, single[mode],
                                                  smi)
        check(single[mode]["xStart"].shape[0] == PAIR_FRAGS[mode],
              f"{what}: fragments")
        check(stats["windows"] == 5 and stats["hit_totals"] == PAIR_HITS
              and stats["seed_counts"] == PAIR_SEEDS,
              f"{what}: {stats['windows']} windows, sums {stats['hit_totals']} "
              f"{stats['seed_counts']}")
        check(counted[mode][mode] > 0, f"{what} launched {counted[mode]}")
        device_part = wall - stats["families"]
        print(f"#   {what}: device part {device_part:.6f} s (wall less "
              f"clustering; final merge {stats['merge']:.6f} s over "
              f"{stats['windows'] * 2 * cfg.seed_cap} rows)")
    check(counted["ungapped"]["banded"] == 0,
          "streamed config #3 ungapped launched K1")
    return counted


def phase_stage_timing():
    """``--stage-timing`` through the CLI in its own process on the card:
    its JSONL records carry the reference's stages and count fields."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "repkiller_tpu_torch.cli", "run",
             str(GOLDEN / "golden30k.fasta"), "-o", os.path.join(tmp, "g"),
             "--device", "cuda", "--stage-timing", *GOLDEN_FLAGS], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"--stage-timing failed: {proc.stderr[-2000:]}")
    records = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    got = {r["stage"]: sorted(r) for r in records[:-1]}
    want = {st: sorted(["stage", "wall_s"] + f) for st, f in STAGE_RECORDS.items()}
    check(got == want and records[-1]["stage"] == "run",
          f"--stage-timing records {records}")
    for r in records[:-1]:
        print(f"# --stage-timing on golden30k: {json.dumps(r)}")


def phase_sharded_headline(codes: np.ndarray, single: dict, smi: str) -> dict:
    """compare_sharded on the headline at each mesh shape of SHARDED_SHAPES,
    one-process meshes of bodies all on the card, both modes, against
    device.compare's output -> {(mode, shape): launch counts}. A shape
    that the capacity checks refuse at the headline's capacities is
    printed with the reference's error and runs again with the capacity
    that utils/capacity.grow_capacity doubles, launches counted anew."""
    counted = {}
    for mode in ("banded", "ungapped"):
        cfg = HEADLINE_CFG.replace(extend_mode=mode)
        for shape in SHARDED_SHAPES:
            what = f"sharded {mode} headline on a {shape[0]}x{shape[1]} mesh"
            mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
            used = cfg
            for attempt in range(2):
                reset_launches()
                t0 = time.perf_counter()
                try:
                    frag = compare_sharded(codes, None, used, mesh)
                    break
                except ValueError as e:
                    grown = grow_capacity(used, str(e))
                    check(attempt == 0 and grown is not None,
                          f"{what} refused again: {e}")
                    print(f"# {what}: refused at the headline's capacities "
                          f"({e}); runs with {grown[1]}")
                    used = grown[0]
            wall = time.perf_counter() - t0
            counted[(mode, shape)] = c = launches()
            check_same(frag, single[mode], what)
            check(c[mode] > 0 and (mode == "banded" or c["banded"] == 0),
                  f"{what} launched {c}")
            print(f"# {what}: {frag['xStart'].shape[0]} fragments, equal to "
                  f"device.compare; wall {wall:.6f} s on {smi}; K1 launches "
                  f"{c['banded']}, K2 launches {c['ungapped']}")
    return counted


def make_config4() -> np.ndarray:
    """benchmarks/run_config4.py's genome: two records (2L, 2R) of half
    the size each, joined by one N."""
    half = CONFIG4_SIZE // 2
    g2l = synth.plant(half, CONFIG4_FAMS, seed=CONFIG4_SEEDS[0])
    g2r = synth.plant(CONFIG4_SIZE - half, CONFIG4_FAMS, seed=CONFIG4_SEEDS[1])
    return np.concatenate([g2l.codes, np.array([4], np.uint8), g2r.codes])


def big_run(what: str, run, cfg: Config, smi: str):
    """One counted run of a large configuration under with_auto_capacity
    (as the reference's benchmarks/common.run_timed) -> (output, the
    Config used, wall, launch counts)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    frag, used = with_auto_capacity(run, cfg)
    wall = time.perf_counter() - t0
    counted = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grown = {f: getattr(used, f) for f in ("hit_capacity", "seed_capacity",
                                           "shard_slack")
             if getattr(used, f) != getattr(cfg, f)}
    check(counted[cfg.extend_mode] > 0, f"{what} launched {counted}")
    clus = clustering(frag, used, True)
    print(f"# {what}: wall {wall:.6f} s, clustering {clus:.6f} s (timed "
          f"apart), the rest {wall - clus:.6f} s (wall less clustering), "
          f"peak device memory {peak:.3f} GiB, launches {counted}, capacities "
          f"grown {grown or 'none'} on {smi}")
    return frag, used, wall, counted


def phase_config2(smi: str) -> dict:
    g = synth.plant(CONFIG2_SIZE, CONFIG2_FAMS, seed=CONFIG2_SEED)
    frag, used, _, counted = big_run(
        "config #2 (device.compare)",
        lambda c: tdevice.compare(g.codes, None, c, "cuda"), BIG_CFG, smi)
    stats = family_stats(frag, frag["group"])
    got = {"fragments": int(frag["xStart"].shape[0]),
           "families": int(np.unique(frag["group"]).shape[0]),
           "largest family": int(stats["n_frags"].max())}
    check(got == CONFIG2_WANT, f"config #2 gave {got}, want {CONFIG2_WANT}")
    print(f"# config #2: {got}, as the JAX package's")
    return frag


def masking(codes: np.ndarray, frag: dict, cfg: Config) -> dict:
    """run_config4.py's masking counts: repeat intervals on X, and the bp
    that masking adds to the genome's Ns."""
    iv = repeat_intervals(frag, frag["group"], cfg, self_cmp=True)
    masked = report_iv.mask_codes(codes, iv.get(0))
    return {"fragments": int(frag["xStart"].shape[0]),
            "repeat intervals": int(iv.get(0, np.zeros((0, 2))).shape[0]),
            "masked bp": int((masked == 4).sum() - (codes == 4).sum())}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_config4(smi: str, rate: float) -> dict:
    """Config #4 through compare_sharded over make_mesh(): the one-process
    mesh, then a one-rank NCCL process mesh, each against the records;
    then K1 against the plain version on window 0 strand f's phase-1
    set -> (the genome, the one-process mesh's output)."""
    import torch.distributed as dist

    codes = make_config4()
    print(f"# config #4 genome: {codes.shape[0]} bp (two records)")
    counted = {}
    frag, used, _, counted["one-process"] = big_run(
        "config #4 on the one-process mesh",
        lambda c: compare_sharded(codes, None, c, make_mesh()), BIG_CFG, smi)
    got = masking(codes, frag, used)
    check(got == CONFIG4_WANT, f"config #4 gave {got}, want {CONFIG4_WANT}")
    print(f"# config #4 on the one-process mesh: {got}, as the JAX package's")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        check(isinstance(mesh, ProcessMesh), f"{mesh} is not a process mesh")
        for run in ("first", "second"):     # the first sets up the communicators
            frag2, _, _, counted["NCCL process mesh"] = big_run(
                f"config #4 on the one-rank NCCL process mesh, {run} run",
                lambda c: compare_sharded(codes, None, c, mesh), used, smi)
    finally:
        dist.destroy_process_group()
    check_same(frag2, frag, "config #4 on the NCCL process mesh")
    print(f"# config #4 on the one-rank NCCL process mesh: "
          f"{masking(codes, frag2, used)}, equal to the one-process mesh "
          "field for field")
    del frag2
    kernel, recorded = record_launches(
        "banded_gotoh", lambda: compare_sharded(codes, None, used, make_mesh()))
    args = recorded[0]
    check(args[10] == PHASE1_ROWS and args[6] == +1,
          f"the first K1 launch is not a phase-1 pass, right: {args[5:-1]}")
    err, _ = compare_k1(args[:5], args[5:-1], args[-1])
    ms = time_device(lambda: kernel(*args))
    print(f"# K1 == plain on config #4's window 0, strand f, phase 1 (right): "
          f"exact ({int(args[-1])} live seeds of {args[0].shape[0]}); K1 "
          f"{ms:.6f} ms on {smi}")
    return codes, frag


def phase_config5(smi: str) -> dict:
    g = synth.plant(CONFIG5_SIZE, CONFIG5_FAMS, seed=CONFIG5_SEED)
    frag, _, _, counted = big_run(
        "config #5 at 0.25x on the one-process mesh",
        lambda c: compare_sharded(g.codes, None, c, make_mesh()), CONFIG5_CFG, smi)
    n = int(frag["xStart"].shape[0])
    check(n == CONFIG5_FRAGS, f"config #5 gave {n} fragments, want {CONFIG5_FRAGS}")
    print(f"# config #5 at 0.25x ({CONFIG5_SIZE} bp): {n} fragments, as the "
          "JAX package's")
    return frag


def pileup_frags(n_loci: int, copies: int = 32, seed: int = 5) -> dict:
    """benchmarks/cluster_chip_bench.py's synthetic_pileups, copied: n_loci
    repeat loci of ``copies`` same-locus fragments each, about n_loci *
    copies^2 / 2 edges."""
    rng = np.random.default_rng(seed)
    n = n_loci * copies
    base = np.repeat(rng.integers(0, 1 << 27, n_loci), copies)
    jit_ = rng.integers(0, 8, n)
    xs = (base + jit_).astype(np.int32)
    ln = rng.integers(150, 170, n).astype(np.int32)
    ys = rng.integers(0, 1 << 27, n).astype(np.int32)
    frag = {
        "xStart": xs, "xEnd": xs + ln - 1,
        "yStart": ys, "yEnd": ys + ln - 1,
        "strand": np.zeros(n, np.int32), "length": ln,
        "score": ln * 4, "idents": ln,
    }
    order = np.lexsort((frag["yStart"], frag["xStart"], frag["strand"]))
    return {k: v[order] for k, v in frag.items()}


def cluster_both_paths(what: str, frag: dict, cfg: Config, self_cmp: bool,
                       smi: str) -> dict:
    """Both clustering paths of families/cluster.py on one output table,
    on the card: the host path three times, the device path once for its
    counters and peak memory and then three times; every call's labels
    against the host path's -> the row's numbers."""
    frag = {f: v for f, v in frag.items() if f != "group"}
    n = int(frag["xStart"].shape[0])
    t0 = time.perf_counter()
    *_, total, _ = tcluster._edge_ranges(frag, cfg, self_cmp)
    table_s = time.perf_counter() - t0
    host_s, dev_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host = cluster_families(frag, cfg, self_cmp,
                                device_min_fragments=1 << 62, device="cuda")
        host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with trace.job() as job_id:
        got = cluster_families(frag, cfg, self_cmp, device_min_fragments=0,
                               device="cuda")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    stats = next(s["counters"] for s in trace.spans()
                 if s["job"] == job_id and s["name"] == "families.propagate")
    check(stats["path"] == 1 and np.array_equal(got, host),
          f"{what}: device labels differ")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cluster_families(frag, cfg, self_cmp, device_min_fragments=0,
                               device="cuda")
        dev_s.append(time.perf_counter() - t0)
        check(np.array_equal(got, host), f"{what}: device labels differ")
    row = {"fragments": n, "edges": total, "kept": stats["edges"],
           "blocks": stats["blocks"], "rounds": stats["rounds"],
           "families": int(np.unique(host).shape[0]),
           "host_s": statistics.median(host_s),
           "device_s": statistics.median(dev_s), "table_s": table_s,
           "peak_mib": peak}
    print(f"# clustering, {what}: {n} fragments, {total} edges in "
          f"{row['blocks']} blocks, {row['kept']} after the ratio filter, "
          f"{row['rounds']} rounds, {row['families']} families; host path "
          f"{row['host_s']:.6f} s {[round(t, 6) for t in host_s]} (its "
          f"interval table {table_s:.6f} s), device path "
          f"{row['device_s']:.6f} s {[round(t, 6) for t in dev_s]}, device "
          f"peak {peak:.1f} MiB above the entry; labels equal on {smi}")
    return row


def phase_clustering(tables: list, codes: np.ndarray, single: dict,
                     smi: str) -> None:
    """Phase 16: cluster_both_paths on every output table and pileup; then
    device.compare on the banded headline with the default rule, launches
    counted, against phase 5's output and the host path's labels, with the
    path it took, its edges and blocks."""
    rows = {}
    for what, frag, cfg, self_cmp in tables:
        rows[what] = cluster_both_paths(what, frag, cfg, self_cmp, smi)
    for loci in PILEUP_LOCI:
        t0 = time.perf_counter()
        frag = pileup_frags(loci)
        what = f"dense pileup {loci} loci x 32"
        print(f"# {what}: made in {time.perf_counter() - t0:.3f} s")
        rows[what] = cluster_both_paths(what, frag, Config(), True, smi)
    print("# clustering, device path against host path (s): " + "; ".join(
        f"{w}: {r['edges']} edges, {r['device_s']:.6f} vs {r['host_s']:.6f}"
        for w, r in rows.items()))

    reset_launches()
    t0 = time.perf_counter()
    with trace.job() as job_id:
        frag = tdevice.compare(codes, None, HEADLINE_CFG, "cuda")
    wall = time.perf_counter() - t0
    counted = launches()
    stats = next(s["counters"] for s in trace.spans()
                 if s["job"] == job_id and s["name"] == "families.propagate")
    check_same(frag, single, "banded headline with the default rule")
    host = cluster_families({f: v for f, v in single.items() if f != "group"},
                            HEADLINE_CFG, True, device_min_fragments=1 << 62)
    check(np.array_equal(frag["group"], host),
          "the default rule's labels differ from the host path's")
    check(counted["banded"] > 0, f"the headline launched {counted}")
    n = frag["xStart"].shape[0]
    want = 1 if n >= tcluster.DEVICE_MIN_FRAGMENTS else 0
    check(stats["path"] == want,
          f"the default rule took path {stats['path']} at {n} fragments")
    print(f"# banded headline with the default rule: path {stats['path']} "
          f"({n} fragments, threshold {tcluster.DEVICE_MIN_FRAGMENTS}; "
          f"{stats['edges']} edges kept, {stats['blocks']} blocks, "
          f"{stats['rounds']} rounds); output equal to phase 5's field for "
          f"field and labels to the host path's; wall {wall:.6f} s, "
          f"launches {counted} on {smi}")


def fasta_bytes(records: list, width: int = 80) -> bytes:
    """(name, codes) records, none empty, as FASTA text, ``width`` bases a
    line."""
    letters = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for name, codes in records:
        n = codes.shape[0]
        rows = -(-n // width)
        bases = np.zeros(rows * width, np.uint8)
        bases[:n] = letters[codes]
        grid = np.full((rows, width + 1), ord("\n"), np.uint8)
        grid[:, :width] = bases.reshape(rows, width)
        # n bases and a newline after every full line, then the last one
        out += [b">" + name.encode() + b"\n",
                grid.reshape(-1)[: n + rows - 1].tobytes() + b"\n"]
    return b"".join(out)


def median_time(fn, reps: int = 3):
    """(median seconds of ``reps`` calls, the last call's result)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, out


def phase_native_io(codes4: np.ndarray, pair_frag: dict, smi: str) -> None:
    """Phase 17: read_fasta through the native parser and through the numpy
    parse on config #4 as a two-record FASTA; config #3's banded fragments
    through the native and the Python CSV writers."""
    check(native.available(), "the native I/O library is not available")
    half = CONFIG4_SIZE // 2
    records = [("2L", codes4[:half]), ("2R", codes4[half + 1:])]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config4.fa")
        t0 = time.perf_counter()
        Path(path).write_bytes(fasta_bytes(records))
        print(f"# config #4 as FASTA: {os.path.getsize(path)} bytes written in "
              f"{time.perf_counter() - t0:.3f} s")
        nat_s, nat_all, got = median_time(lambda: tfasta.read_fasta(path))
        npy_s, npy_all, want = median_time(lambda: tfasta.parse_numpy(
            Path(path).read_bytes(), path=path))
        check(got.names == want.names == ["2L", "2R"] and got.path == want.path
              and all(np.array_equal(getattr(got, f), getattr(want, f))
                      and getattr(got, f).dtype == getattr(want, f).dtype
                      for f in ("codes", "offsets", "lengths")),
              "config #4: the native and numpy FASTA parses differ")
        check(np.array_equal(got.record(0), records[0][1])
              and np.array_equal(got.record(1), records[1][1]),
              "config #4: the parsed records differ from the genome")
        print(f"# read_fasta of config #4 ({got.total_length} codes, records "
              f"{got.lengths.tolist()}): native {nat_s:.6f} s "
              f"{[round(t, 6) for t in nat_all]}, numpy {npy_s:.6f} s "
              f"{[round(t, 6) for t in npy_all]}; equal SeqSets on {smi}")

        n = int(pair_frag["xStart"].shape[0])
        kw = dict(x_name="strainA", y_name="strainB", x_len=PAIR_SIZE,
                  y_len=PAIR_SIZE + 5000, total_hits=sum(PAIR_HITS))
        nat_csv, py_csv = os.path.join(tmp, "native.csv"), os.path.join(tmp, "py.csv")

        def python_writer():        # the rows without the native library
            with mock.patch.object(native, "available", lambda: False):
                csv_writer.write_frags_csv(pair_frag, py_csv, **kw)

        nat_s, nat_all, _ = median_time(
            lambda: csv_writer.write_frags_csv(pair_frag, nat_csv, **kw))
        py_s, py_all, _ = median_time(python_writer)
        data = Path(nat_csv).read_bytes()
        check(data == Path(py_csv).read_bytes(),
              "config #3: the native and Python CSV writers differ")
        buf = io.StringIO()
        csv_writer.write_frags_csv(pair_frag, buf, **kw)
        check(buf.getvalue().encode() == data,
              "config #3: the native writer's stream and file differ")
        check(data.count(b"\nFrag,") == n, "config #3: CSV rows")
        print(f"# write_frags_csv of config #3 banded ({n} fragments, "
              f"{len(data)} bytes): native {nat_s:.6f} s "
              f"{[round(t, 6) for t in nat_all]}, Python {py_s:.6f} s "
              f"{[round(t, 6) for t in py_all]}; equal bytes on {smi}")


def main() -> int:
    n_gpus = machine_gpu_count()
    gpu = pin_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = card(gpu)
    rate = int32_rate(gpu)
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(f"# GPUs on this machine before the pin (nvidia-smi -L): {n_gpus}; "
          f"the run uses card {gpu} alone")
    phase_build()
    err2 = phase_k2_vs_plain(dev)
    err1 = phase_k1_vs_plain(dev)
    phase_golden()
    phase_cli()

    g = synth.plant(HEADLINE_SIZE, HEADLINE_FAMS, seed=1234)
    cx = torch.from_numpy(g.codes.copy()).to(dev)
    k1_counted, single_banded = phase_headline(g.codes, cx, HEADLINE_CFG, smi)
    check(k1_counted["banded"] > 0, "the banded headline did not launch K1")
    phase_profile(cx, HEADLINE_CFG, smi)
    err1b, k1_ms, k1_plain_ms, k1_bound, k1_by = phase_k1_headline_sets(
        cx, smi, rate)

    k2_counted, single_ungapped = phase_headline(g.codes, cx, UNGAPPED_CFG, smi)
    check(k2_counted["ungapped"] > 0 and k2_counted["banded"] == 0,
          f"the ungapped headline launched {k2_counted}: K2 > 0 and K1 == 0 "
          "expected")
    phase_profile(cx, UNGAPPED_CFG, smi)
    err2b, k2_ms, k2_plain_ms, k2_bound, k2_by = phase_k2_headline_sets(
        cx, smi, rate)
    del cx
    torch.cuda.empty_cache()

    pair_counted, pair_frags = phase_pairwise(smi)
    check(pair_counted["ungapped"]["banded"] == 0,
          "config #3 ungapped launched K1")

    phase_staged(g.codes, single_banded, smi)
    phase_streamed_headline(
        g.codes, {"banded": single_banded, "ungapped": single_ungapped}, smi)
    phase_window_sets(g.codes, smi)
    phase_streamed_pair(*make_strain_pair(PAIR_SIZE, PAIR_SEED), pair_frags, smi)
    phase_stage_timing()
    phase_sharded_headline(
        g.codes, {"banded": single_banded, "ungapped": single_ungapped}, smi)
    frag2 = phase_config2(smi)
    codes4, frag4 = phase_config4(smi, rate)
    frag5 = phase_config5(smi)
    phase_clustering([
        ("banded headline", single_banded, HEADLINE_CFG, True),
        ("config #3 banded", pair_frags["banded"], PAIR_CFG, False),
        ("config #2", frag2, BIG_CFG, True),
        ("config #4", frag4, BIG_CFG, True),
        ("config #5 at 0.25x", frag5, CONFIG5_CFG, True)], g.codes,
        single_banded, smi)
    phase_native_io(codes4, pair_frags["banded"], smi)
    print(f"# chip_smoke phases took {time.perf_counter() - t_start:.3f} s")

    print(json.dumps({"kernels": [
        {"name": "banded_gotoh", "route": "cuda",
         "source": "repkiller_tpu_torch/csrc/banded_gotoh.cu",
         "replaces": "repkiller_tpu/extend/banded_pallas.py:103",
         "launches": k1_counted["banded"], "max_abs_err": max(err1, err1b),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "ungapped_xdrop", "route": "cuda",
         "source": "repkiller_tpu_torch/csrc/ungapped_xdrop.cu",
         "replaces": "repkiller_tpu/extend/ungapped_pallas.py:30",
         "launches": k2_counted["ungapped"], "max_abs_err": max(err2, err2b),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
