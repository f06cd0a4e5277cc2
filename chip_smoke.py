#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. build kernel K1 (repkiller_tpu_torch/csrc/banded_gotoh.cu) with nvcc;
  2. K1 == its plain torch version (extend/banded.direction_plain), exactly,
     on random seeds at bands 4, 8, 15, 16, in the phase-1 shape
     (192 rows, jcap 192 + band) and the full shapes (512 and 2048 rows,
     jcap = rows);
  3. the golden 30 kb test: CSV and BED byte for byte through api.compare;
  4. the headline self-comparison (bench.py's 4.19 Mbp synthetic genome,
     k=12, strands fr, banded): 139,287 fragments and hit totals
     [543009, 535532]; wall time and per-stage times of warm runs; device
     time by kernel and the device's idle share from torch.profiler;
  5. K1 == the plain version, exactly, on the headline's own seed sets:
     phase 1 over every seed of both strands in both directions, then the
     full-depth pass (2048 rows) over the seeds phase 1 left alive; K1's
     time against the plain version's.

Informational lines come first; the last two lines are the kernels' JSON
record and the device's JSON record. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repkiller_tpu.config import Config
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import api, device as tdevice
from repkiller_tpu_torch.extend import _cuda
from repkiller_tpu_torch.extend.banded import direction_plain
from repkiller_tpu_torch.utils.scan import partition_live

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
GOLDEN_CFG = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=512,
                    extend_mode="banded", band=8)
# bench.py:71-78: the genome, families and Config of the headline workload
HEADLINE_SIZE = 1 << 22
HEADLINE_FAMS = [(1024, 6, 0.02, 2), (768, 5, 0.05, 1), (512, 7, 0.0, 0),
                 (1536, 3, 0.03, 1), (256, 8, 0.08, 2)]
HEADLINE_CFG = Config(k=12, strands="fr", extend_mode="banded",
                      hit_capacity=1 << 20, seed_capacity=1 << 19,
                      max_extend=2048)
HEADLINE_FRAGS = 139287
HEADLINE_HITS = [543009, 535532]
PHASE1_ROWS = 192


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def pin_one_card() -> str:
    """Make the first visible card the only one CUDA sees (before CUDA is
    initialised), so the run uses, and reports, exactly one device."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def card(gpu: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", gpu, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_args(cfg: Config, E: int, jcap: int, base_off: int, step: int):
    return (base_off, step, cfg.match, cfg.mismatch, cfg.x_drop, E, cfg.band,
            cfg.gap_open, cfg.gap_extend, jcap)


def compare_kernel(inputs, args, n_live):
    """Run K1 and the plain version on the same inputs -> (max |diff|,
    K1's outputs)."""
    got = _cuda.banded_gotoh(*inputs, *args, n_live)
    want = direction_plain(*inputs, *args, n_live)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if err:
        bad = torch.nonzero(torch.stack(got) != torch.stack(want))[:5].tolist()
        raise RuntimeError(f"K1 != plain for args {args}: max |diff| {err}, "
                           f"first (output, seed) pairs {bad}")
    return err, got


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
    so = _cuda.build()
    print(f"# build: {so.name} in {time.perf_counter() - t0:.3f} s")
    log = Path(f"{so}.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"#   ptxas: {line.strip()}")


def phase_kernel_vs_plain(dev) -> int:
    worst = 0
    for band in (4, 8, 15, 16):
        cfg = HEADLINE_CFG.replace(band=band)
        inputs, n_live = random_case(band, 4096, 60000, dev)
        for E, jcap in ((PHASE1_ROWS, PHASE1_ROWS + band), (512, 512),
                        (2048, 2048)):
            for base_off, step in ((cfg.k, +1), (-1, -1)):
                args = kernel_args(cfg, E, jcap, base_off, step)
                err, got = compare_kernel(inputs, args, n_live)
                worst = max(worst, err)
                print(f"# K1 == plain: band {band} E {E} jcap {jcap} "
                      f"step {step:+d}: exact ({int(got[4].sum())} alive "
                      "at the cap)")
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


def phase_headline(codes: np.ndarray, cx: torch.Tensor, smi: str):
    # first run: device-side counts against the pinned record
    t0 = time.perf_counter()
    out, n_frags, totals, n_seeds = tdevice.compare_fn(cx, HEADLINE_CFG)
    torch.cuda.synchronize()
    print(f"# headline first run (device part, incl. load): "
          f"{time.perf_counter() - t0:.3f} s")
    check(int(n_frags) == HEADLINE_FRAGS,
          f"headline fragments {int(n_frags)} != {HEADLINE_FRAGS}")
    check(totals.tolist() == HEADLINE_HITS,
          f"headline hit totals {totals.tolist()} != {HEADLINE_HITS}")
    print(f"# headline: {int(n_frags)} fragments, hit totals "
          f"{totals.tolist()}, seeds {n_seeds.tolist()}")

    # warm runs through the entry point, the third one counted
    walls, stages = [], []
    for r in range(3):
        if r == 2:
            _cuda.banded_gotoh.launches = 0
            torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        frag = tdevice.compare(codes, None, HEADLINE_CFG, "cuda",
                               timings=timings)
        walls.append(time.perf_counter() - t0)
        stages.append(timings)
        check(frag["xStart"].shape[0] == HEADLINE_FRAGS,
              f"headline fragments {frag['xStart'].shape[0]}")
        check(all(np.isfinite(v).all() and v.shape == (HEADLINE_FRAGS,)
                  for v in frag.values()), "headline output malformed")
    launches = _cuda.banded_gotoh.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"# headline warm walls (s): {[round(w, 6) for w in walls]}, "
          f"median {statistics.median(walls):.6f} s on {smi}")
    for name in stages[0]:
        vals = [s[name] for s in stages]
        print(f"#   stage {name}: {[round(v, 6) for v in vals]} s")
    print(f"# headline peak device memory {peak:.3f} GiB; K1 launches in the "
          f"counted run: {launches}; families {len(np.unique(frag['group']))}")
    check(launches > 0, "the headline did not launch K1")
    return launches


def phase_profile(cx: torch.Tensor, smi: str):
    """Device time by kernel name and the device's idle share over one
    profiled run of the device part of the headline (host clustering
    excluded); profiling adds host overhead, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tdevice.compare_fn(cx, HEADLINE_CFG)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no device activity")
    print(f"# profiled device part: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f} "
          f"on {smi}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"#   {us / 1e3:9.3f} ms  {name[:100]}")


def time_cuda(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_headline_sets(cx: torch.Tensor, smi: str):
    """K1 == the plain version on the headline's own seed sets, for both
    strands and both directions: phase 1 (192 rows, jcap 192 + band) over
    every seed, then the full-depth pass (max_extend rows, jcap max_extend)
    over the seeds phase 1 left alive, compacted to the front with a device
    ``n_live`` as the pipeline's re-run has them. That set holds the
    re-run's own, which also drops the seeds their anchor covers. Times K1
    and the plain version on strand f, right direction, in both passes."""
    cfg = HEADLINE_CFG
    worst, timed = 0, []
    for strand, (spx, spy, sv, n_seeds, _) in tdevice.self_seeds_fn(cx, cfg).items():
        cy = cx if strand == 0 else tdevice.revcomp_device(cx)
        for base_off, step in ((cfg.k, +1), (-1, -1)):
            p1 = ((spx, spy, sv, cx, cy),
                  kernel_args(cfg, PHASE1_ROWS, PHASE1_ROWS + cfg.band,
                              base_off, step), n_seeds)
            err1, got = compare_kernel(*p1)
            need = sv & (got[4] == 1)
            order, _, n2 = partition_live(need)
            p2 = ((spx[order], spy[order], need[order], cx, cy),
                  kernel_args(cfg, cfg.max_extend, cfg.max_extend, base_off,
                              step), n2)
            err2, got2 = compare_kernel(*p2)
            worst = max(worst, err1, err2)
            print(f"# K1 == plain on the headline: strand {'fr'[strand]} step "
                  f"{step:+d}: phase 1 exact ({int(n_seeds)} live seeds of "
                  f"{spx.shape[0]}), full depth exact ({int(n2)} re-run seeds, "
                  f"{int(got2[4].sum())} alive at row {cfg.max_extend})")
            if not timed:
                timed = [p1, p2]
    (ms, plain_ms), (ms2, plain_ms2) = [
        (time_cuda(lambda: _cuda.banded_gotoh(*inp, *args, nl), 20),
         time_cuda(lambda: direction_plain(*inp, *args, nl), 2))
        for inp, args, nl in timed]
    print(f"# K1 on the headline, strand f, right direction: phase 1 kernel "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms; full depth kernel "
          f"{ms2:.6f} ms, plain {plain_ms2:.6f} ms on {smi}")
    return worst, ms, plain_ms


def main() -> int:
    gpu = pin_one_card()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card(gpu)
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    err = phase_kernel_vs_plain(dev)
    phase_golden()
    g = synth.plant(HEADLINE_SIZE, HEADLINE_FAMS, seed=1234)
    cx = torch.from_numpy(g.codes.copy()).to(dev)
    launches = phase_headline(g.codes, cx, smi)
    phase_profile(cx, smi)
    err5, ms, plain_ms = phase_headline_sets(cx, smi)
    print(json.dumps({"kernels": [{
        "name": "banded_gotoh", "route": "cuda",
        "source": "repkiller_tpu_torch/csrc/banded_gotoh.cu",
        "replaces": "repkiller_tpu/extend/banded_pallas.py:103",
        "launches": launches, "max_abs_err": max(err, err5),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
