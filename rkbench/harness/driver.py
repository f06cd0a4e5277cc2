"""One run of one cell: set-up, the measured window of back-to-back jobs,
the traced jobs (``trace``), and the comparison with the plain reference.

The load is a closed loop with one caller: a batch annotation pipeline
calls the program once per genome and waits for the result. Job j reads
pool genome j mod P. Jobs start one after another until ``seconds`` have
passed since the first one started; every job started completes and
counts. Each job is timed host to host, from the call that reads its
FASTA until its last output file is closed. A pairwise configuration's
jobs each read a pair of genomes and compare the first with the second.
A cell on several chips runs every job on every rank at once (``ranks``)
and is measured on rank 0, its peak memory on the fullest card.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, genomes, profile, reference, report, roofline
from .manifest import Cell


@dataclass
class JobRecord:
    start: float
    end: float
    bp: int
    ok: bool
    genome: int


@dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    cell: Cell
    setup_s: float
    jobs: List[JobRecord]
    peak_bytes: int
    spans: Dict[str, float] = field(default_factory=dict)
    stages: Dict[str, float] = field(default_factory=dict)
    trace: Optional[profile.Trace] = None
    least_s: float = 0.0           # roofline time of the traced jobs' kernels

    @property
    def done(self) -> List[JobRecord]:
        return [j for j in self.jobs if j.ok]

    @property
    def backend(self) -> str:
        return self.cell.config["backend"]

    @property
    def mode(self) -> str:
        return self.cell.settings["extend_mode"]

    def per_job(self, seconds: Optional[float]) -> Optional[float]:
        if seconds is None or not self.done:
            return None
        return seconds / len(self.done)


def checked_genomes(seed: int, used: List[int], n: int,
                    pool: int) -> List[int]:
    """The genomes whose jobs are checked: the first ``n`` of a permutation
    of the pool drawn from the seed, among those the window used."""
    order = np.random.default_rng([int(seed), 1]).permutation(pool).tolist()
    return [g for g in order if g in used][:n]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             workdir: str, t0: float, log=print):
    """-> (the Run, the numbers compared). A cell on several chips runs as
    as many ranks, this process rank 0 on ``device`` (``ranks``); the
    reference runs here once the other ranks have stopped."""
    from .job import Job, Spans, install_family_span

    cfg = cell.config
    if cell.traffic["loop"] != "closed" or cell.traffic["callers"] != 1:
        raise ValueError("the generator drives one caller in a closed loop")
    if cfg["comparison"] not in ("self", "pair"):
        raise ValueError(f"unknown comparison {cfg['comparison']!r}")
    ranks = None
    if cell.chips > 1:
        from .ranks import RankedJob, Ranks
        ranks = Ranks(cell.chips, device, log, cleanup=lambda: shutil.rmtree(
            workdir, ignore_errors=True))
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    def prefix(tag: str, g: int) -> str:
        return os.path.join(workdir, f"{tag}{g}")

    spans = Spans(trace)
    stages = {} if trace and cfg["backend"] == "device" else None
    remove = None
    failures = []

    try:
        pool = genomes.make_pool(cfg, seed, workdir)
        if ranks is not None:
            ranks.join(cfg, cell.settings)
        job = Job(cfg, cell.settings, device)
        if ranks is not None:
            job = RankedJob(ranks, job)
        remove = install_family_span(spans) if trace else None

        def one(g: int, tag: str, sp, st):
            s = time.perf_counter()
            try:
                frag = job.run(pool[g]["path"], prefix(tag, g), sp, st,
                               pool[g].get("path_y"))
            except Exception:                 # a failed job is a wrong answer
                failures.append(traceback.format_exc())
                frag = None
            return s, time.perf_counter(), frag

        one(0, "warm", Spans(False), None)
        sync()
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0

        jobs, tables = [], defaultdict(list)
        first = time.perf_counter()
        while not jobs or time.perf_counter() - first < seconds:
            g = len(jobs) % len(pool)
            s, e, frag = one(g, "out", spans, stages)
            jobs.append(JobRecord(s, e, pool[g]["bp"], frag is not None, g))
            if frag is not None:
                tables[g].append(frag)
        if ranks is not None:
            peak = ranks.peak()
        else:
            peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        used = sorted({j.genome for j in jobs})
        sample = checked_genomes(seed, used, cell.traffic["check_genomes"],
                                 len(pool))
        tagged = {g: ["out"] for g in sample}
        run = Run(cell, setup_s, jobs, peak, dict(spans.total),
                  dict(stages or {}))

        prof_jobs = []
        if trace:                 # the traced jobs' spans, kept apart
            remove()
            prof_spans = Spans(True)
            remove = install_family_span(prof_spans)
            run.trace, prof_jobs = _profiled(cfg, sample, one, prof_spans,
                                             tables, on_cuda, ranks)
            for g in set(prof_jobs):
                tagged[g].append("prof")
    finally:
        if remove is not None:
            remove()
        if ranks is not None:
            ranks.close()
    del job
    if on_cuda:
        torch.cuda.empty_cache()

    numbers = {"failed_jobs": len(failures)}
    for text in failures[:3]:
        log(text)
    p = reference.Params.from_dict(cell.settings)
    work = {}
    for g in sample:
        parsed, parsed_y = parse_entry(pool[g])
        want, work[g] = reference.compare(
            parsed.codes, p, device,
            codes_y=None if parsed_y is None else parsed_y.codes)
        want_files = report.render(want, parsed, p.min_family, cfg["mask"],
                                   parsed_y)
        files = [{s: _read(prefix(tag, g) + "." + s) for s in want_files}
                 for tag in tagged[g]]
        for k, v in check.compare(tables[g], files, want, want_files).items():
            numbers[k] = numbers.get(k, 0) + v
        del want, want_files, files
    for k in check.LIMITS:
        numbers.setdefault(k, 0)
    if not sample:
        numbers["failed_jobs"] = max(numbers["failed_jobs"], 1)
    if trace and prof_jobs and on_cuda:
        run.least_s = _least_seconds(cell, p, prof_jobs, work, pool, log)
    return run, numbers


def parse_entry(entry: dict):
    """A pool entry's genomes as the reference parses them -> (X, Y or
    None)."""
    out = []
    for key in ("path", "path_y"):
        if key in entry:
            with open(entry[key], "rb") as f:
                out.append(report.parse_fasta(f.read()))
    return out[0], (out[1] if len(out) > 1 else None)


def _read(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


def _profiled(cfg: dict, sample: List[int], one, spans, tables, on_cuda,
              ranks=None):
    """Whole jobs under ``torch.profiler`` on the checked genomes ->
    (their Trace, the genome of each). On several ranks each profiles its
    own card, and the Trace's busy seconds and window are the means over
    the ranks; its kernels and idle gaps are this rank's."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    genomes_run = [sample[q % len(sample)] for q in range(cfg["profiled_jobs"])]
    if ranks is not None:
        ranks.profile(True)
    with torch_profile(activities=acts) as prof:
        for g in genomes_run:
            with torch.profiler.record_function(profile.SPAN + "job"):
                _, _, frag = one(g, "prof", spans, None)
            if frag is not None:
                tables[g].append(frag)
    if ranks is not None:
        ranks.profile(False)
    tr = profile.from_profiler(prof)
    if ranks is not None:
        each = [(tr.busy_s, tr.window_s)] + ranks.profiled()
        ranks.log("# device busy / window by rank (s): " + " ".join(
            f"{b:.4f}/{w:.4f}" for b, w in each))
        tr = dataclasses.replace(
            tr, busy_s=sum(b for b, _ in each) / len(each),
            window_s=sum(w for _, w in each) / len(each))
    return tr, genomes_run


def _least_seconds(cell: Cell, p, prof_jobs, work, pool, log) -> float:
    """The least time the traced jobs' extension kernels could take on this
    card, from the work the reference counted on their genomes."""
    props = torch.cuda.get_device_properties(0)
    mhz = float(roofline.smi("clocks.max.sm").split()[0])
    rate = roofline.int32_per_s(props.multi_processor_count, mhz)
    total = 0.0
    for g in prof_jobs:
        ops = roofline.ops(p.extend_mode, work[g]["work"], p.band)
        nb = roofline.nbytes(p.extend_mode, work[g]["extended"], pool[g]["bp"])
        total += roofline.least_seconds(ops, nb, rate)
        log(f"# roofline work, genome {g}: {work[g]['work']} "
            f"{'rows' if p.extend_mode == 'banded' else 'steps'}, {ops} int32 "
            f"ops, {nb} bytes; peaks {rate / 1e12:.4f} T int32 op/s "
            f"({props.multi_processor_count} SMs at {mhz} MHz), "
            f"{roofline.HBM_BYTES_PER_S / 1e12} TB/s")
    return total


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that a run must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & {"jax", "jaxlib", "flax", "repkiller_tpu"})
