"""A cell on several cards, run as ranks (``harness/ranks.py``), held on
the CPU with gloo in place of NCCL, at a tiny ``human_chr1`` shape:

- four ranks give the job tables and files of the plain reference and of
  a one-process run of the same cell;
- a job that raises on every rank, as the program's capacity checks do,
  is a failed job, and the run still ends with a result;
- a helper that raises alone, or that is killed, ends the run with an
  error and no result in bounded time, and leaves no process behind;
- the one-process cells read exactly what they read before ranks were
  added: the sha256 of their tiny runs' tables and files, and of the
  reference's, equal the parent harness's;
- the reference's blocks of extension tasks change nothing.

Rank 0 runs in a process of its own (``_rank0.py``), since a fault ends
it; every such process has a hard timeout, as in
tests/test_torch_multiprocess.py."""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import numpy as np
import pytest

import control
from _tiny import SEED, tiny_cell
from harness import check, driver, genomes, manifest, ranks, reference
from test_rkbench_program_trace import _run, _span, recorder  # noqa: F401

HERE = Path(__file__).resolve().parent
TIMEOUT = 120
CELL = "human_chr1.sharded4"


def _rank0(spec: dict, tag: str):
    """Run ``_rank0.py`` with ``spec`` -> (exit code, its result or None,
    its standard error, seconds)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", RKBENCH_TEST_TAG=tag)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(HERE / "_rank0.py"),
                          json.dumps(spec)], capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=HERE, env=env)
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines else None
    return out.returncode, res, out.stderr, time.monotonic() - t0


def _left(tag: str, wait_s: float = 5.0) -> list:
    """Live processes whose environment carries ``tag``, after waiting up
    to ``wait_s`` for them to end."""
    key = f"RKBENCH_TEST_TAG={tag}".encode()
    deadline = time.monotonic() + wait_s
    while True:
        alive = []
        for d in Path("/proc").iterdir():
            if not d.name.isdigit():
                continue
            try:
                if key not in (d / "environ").read_bytes().split(b"\0"):
                    continue
                state = (d / "stat").read_text().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state != "Z":
                alive.append(int(d.name))
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.2)


def test_four_ranks_equal_the_reference_and_one_process():
    tag = uuid.uuid4().hex
    rc, four, err, _ = _rank0({"trace": True}, tag)
    assert rc == 0, err[-4000:]
    rc, one, err, _ = _rank0({"one_process": True}, tag)
    assert rc == 0, err[-4000:]
    for res in (four, one):
        assert res["numbers"] == {k: 0 for k in check.LIMITS}, res
        assert res["done"] == res["jobs"] >= 1
    assert four["sha"] and set(four["sha"]) == set(one["sha"])
    assert set(four["files"]) == set(one["files"])
    busy, window = four["trace"]
    assert window > 0 and 0 <= busy <= window
    assert not _left(tag)


def test_a_job_that_raises_on_every_rank_is_a_failed_job():
    """The program's capacity checks raise on every rank together: each
    job fails, and the run ends with a result that is not correct."""
    tag = uuid.uuid4().hex
    rc, res, err, _ = _rank0({"settings": {"hit_capacity": 2048,
                                           "seed_capacity": 1024}}, tag)
    assert rc == 0, err[-4000:]
    assert res["done"] == 0 and res["numbers"]["failed_jobs"] >= 1
    assert not check.verdict(res["numbers"])
    assert "per-device hit capacity" in err
    assert not _left(tag)


@pytest.mark.parametrize("fault", [
    {"rank": 2, "kill_on_job": 2},
    {"rank": 1, "raise_in_clustering": True, "control_timeout_s": 10}],
    ids=["killed", "raises_alone"])
def test_a_lost_helper_ends_the_run_without_a_result(fault):
    """A helper killed in its second job, or one whose clustering raises
    alone while rank 0 waits in the writes' barrier: rank 0 exits with
    FATAL_EXIT within seconds of the loss (the control timeout, where the
    helper lives on), prints no result, and no rank is left."""
    tag = uuid.uuid4().hex
    rc, res, err, seconds = _rank0({"seconds": 3.0, "fault": fault}, tag)
    assert rc == ranks.FATAL_EXIT and res is None, err[-4000:]
    assert "the run ends without a result" in err
    assert seconds < 60
    assert not _left(tag)


@pytest.mark.parametrize("kind", ["unchanged", "half", "exchange",
                                  "altered"])
def test_a_fault_of_the_timed_path_makes_the_run_incorrect(kind):
    """The faults the four-rank cell can have, planted alike on every rank
    under a whole run: an unextended step, half of the seeds, the
    exchange between the ranks, one score; ``correct`` comes out false."""
    tag = uuid.uuid4().hex
    rc, res, err, _ = _rank0({"fault": {"program": kind}}, tag)
    assert rc == 0, err[-4000:]
    assert not check.verdict(res["numbers"]), res
    assert not _left(tag)


def test_control_is_incorrect():
    cell = tiny_cell(CELL, length=30000)
    with tempfile.TemporaryDirectory() as d:
        numbers = control.control_numbers(cell, SEED, "cpu", d)
    assert not check.verdict(numbers), numbers
    assert numbers["fragment_rows_differing"] > 0


def _digest(name: str, length: int, mode=None) -> str:
    """sha256 of a tiny one-process run of cell ``name``: its pool's FASTA
    bytes, every checked job's table and files, and the reference's table
    and files they were compared with, in the order the run compared
    them."""
    cell = tiny_cell(name, length=length)
    if mode is not None:
        cell.traffic["config"]["extend_mode"] = mode
    h = hashlib.sha256()
    orig = check.compare

    def compare(tables, files, want, want_files):
        for t in tables + [want]:
            for f in reference.FIELDS + ("group",):
                h.update(np.ascontiguousarray(t[f], np.int32).tobytes())
        for fs in files + [want_files]:
            for k in sorted(fs):
                h.update(fs[k] or b"")
        return orig(tables, files, want, want_files)

    with tempfile.TemporaryDirectory() as d:
        check.compare = compare
        try:
            run, numbers = driver.run_cell(cell, SEED, 0.0, False, "cpu", d,
                                           time.perf_counter(),
                                           log=lambda *a: None)
        finally:
            check.compare = orig
        for e in genomes.make_pool(cell.config, SEED, d):
            for key in ("path", "path_y"):
                if key in e:
                    with open(e[key], "rb") as f:
                        h.update(f.read())
    assert check.verdict(numbers) and run.done, numbers
    return h.hexdigest()


# The one-process cells as the harness read them before ranks were added:
# the digests the parent harness gave at these sizes.
ONE_PROCESS = {
    ("ecoli_k12_self.banded", 9000, None):
        "3ee9f0e013dc3a39d6da202c43d8f7c9783741922db19897d6acc4cb806b4947",
    ("ecoli_k12_self.ungapped", 20000, None):
        "9f4f9befb980130a339a400024fab26c806ea86436fd9a387c94c3c3e169bf5d",
    ("dmel_2l2r_mask.banded", 8000, None):
        "5adccaeaf3c94e3a695f29a00e28825abbea8843ca7bd32dae5fb8c88917b5f2",
    ("ecoli_strain_pair.banded", 9000, "ungapped"):
        "7db5bf9aebb5b938de8ada17d0de6afa1f6a95612ae0bdcf7685d8157b8cf64c",
}


@pytest.mark.parametrize("name,length,mode", sorted(ONE_PROCESS, key=str))
def test_one_process_cells_read_as_before(name, length, mode):
    assert _digest(name, length, mode) == ONE_PROCESS[name, length, mode]


def test_reference_blocks_change_nothing(monkeypatch):
    cell = tiny_cell(CELL, length=30000)
    codes = genomes.plant(30000, cell.config["families"], 5)
    p = reference.Params.from_dict(cell.settings)
    whole, work = reference.compare(codes, p)
    monkeypatch.setattr(reference, "TASK_BLOCK", 97)
    blocked, work_b = reference.compare(codes, p)
    assert work == work_b and work["extended"] > 97
    assert check.rows_differing(blocked, whole,
                                reference.FIELDS + ("group",)) == 0


def test_regroup_reader_reads_its_span_only(recorder):  # noqa: F811
    _span(recorder, "sharded.regroup", 10.0, 10.5)
    _span(recorder, "sharded.extend", 10.5, 11.0)
    r = recorder._ring
    r[0].device_s, r[1].device_s = 0.25, 0.5
    run = _run([(10.0, 11.0), (11.0, 12.0)])
    assert manifest.reader("sharded_regroup_s")(run) == pytest.approx(0.125)
    assert manifest.reader("sharded_extend_s")(run) == pytest.approx(0.375)
