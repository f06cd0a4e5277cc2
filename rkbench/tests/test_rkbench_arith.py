"""The metric arithmetic on fixed inputs: throughput over all the work and
all the time, the 95th percentile over every job, the per-job layer
times, the trace's device union and idle gaps, the roofline counts, and
the comparison's counting."""

import numpy as np
import pytest

import _tiny  # noqa: F401  (puts the harness on sys.path)
from harness import check, manifest, profile, roofline
from harness.driver import JobRecord, Run


def _run(jobs, **kw):
    cell = manifest.cell("ecoli_k12_self.banded")
    return Run(cell, 12.5, jobs, 3 * 2**30, **kw)


def read(name, run):
    return manifest.reader(name)(run)


def test_throughput_is_all_work_over_all_time():
    jobs = [JobRecord(10.0, 11.0, 4_000_000, True, 0),
            JobRecord(11.0, 13.0, 4_000_000, True, 1),
            JobRecord(13.0, 14.0, 2_000_000, True, 0)]
    assert read("throughput_mbp_s", _run(jobs)) == pytest.approx(10.0 / 4.0)
    # a failed job's time counts, its bases do not
    jobs[1].ok = False
    assert read("throughput_mbp_s", _run(jobs)) == pytest.approx(6.0 / 4.0)


def test_p95_is_over_every_job():
    jobs = [JobRecord(float(i), float(i) + w, 1, True, 0)
            for i, w in enumerate([1.0] * 19 + [3.0])]
    # numpy's linear interpolation: rank 0.95 * 19 = 18.05
    assert read("job_p95_s", _run(jobs)) == pytest.approx(1.0 + 0.05 * 2.0)


def test_peak_setup_and_per_job_spans():
    jobs = [JobRecord(0.0, 1.0, 1, True, 0), JobRecord(1.0, 2.0, 1, True, 0)]
    run = _run(jobs, spans={"fasta_read": 0.2, "families": 1.0,
                            "write": 0.6, "compare": 1.4},
               stages={"seeds": 0.1, "extend": 0.04, "merge": 0.02})
    assert read("device_peak_gib", run) == 3.0
    assert read("setup_s", run) == 12.5
    assert read("fasta_read_s", run) == pytest.approx(0.1)
    assert read("families_s", run) == pytest.approx(0.5)
    assert read("write_s", run) == pytest.approx(0.3)
    assert read("seeds_s", run) == pytest.approx(0.05)
    assert read("extend_s", run) == pytest.approx(0.02)
    assert read("merge_s", run) == pytest.approx(0.01)
    assert read("sharded_s", run) is None          # a device-backend cell
    dmel = Run(manifest.cell("dmel_2l2r_mask.banded"), 1.0, jobs, 1,
               spans={"compare": 3.0, "families": 1.0})
    assert read("sharded_s", dmel) == pytest.approx(1.0)
    assert read("seeds_s", dmel) is None


def test_trace_union_gaps_and_labels():
    # device ops (us): two overlapping kernels and a copy; jobs 0-100
    dev = [("k_gotoh", 10, 30), ("k_gotoh", 20, 40), ("Memcpy", 60, 70)]
    host = [("rkbench.job", 0, 100), ("rkbench.families", 40, 60),
            ("rkbench.write", 70, 100)]
    t = profile.reduce(dev, host, [(0, 100)])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)          # 10-40 and 60-70
    assert t.device_s("gotoh") == pytest.approx(40e-6)   # summed, not unioned
    assert t.idle_by_span == pytest.approx(
        {"other": 10e-6, "families": 20e-6, "write": 30e-6})
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k_gotoh"
    assert b["idle_gaps"][0] == ["write", pytest.approx(30e-6)]
    # one gap across two spans is split between them
    t = profile.reduce([("k", 0, 10), ("k", 90, 100)],
                       [("rkbench.families", 10, 50),
                        ("rkbench.write", 50, 90)], [(0, 100)])
    assert t.idle_by_span == pytest.approx({"families": 40e-6,
                                            "write": 40e-6})
    assert profile.union([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]


def test_roofline_counts():
    assert roofline.ops("banded", 1000, 15) == 1000 * 31 * 30
    assert roofline.ops("ungapped", 1000, 15) == 12_000
    assert roofline.nbytes("ungapped", 10, 100) == 10 * (9 + 12) + 200
    rate = roofline.int32_per_s(132, 1980.0)
    assert rate == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.least_seconds(rate, 0, rate) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12, rate) == pytest.approx(1.0)
    cell = manifest.cell("ecoli_k12_self.banded")
    trace = profile.Trace(window_s=1.0, busy_s=0.25,
                          kernel_s={"banded_gotoh_warp_kernel": 0.02})
    run = Run(cell, 1.0, [], 1, trace=trace, least_s=0.005)
    assert read("k1_roofline", run) == pytest.approx(25.0)
    assert read("k2_roofline", run) is None
    assert read("device_idle_share", run) == pytest.approx(75.0)
    # no kernel of its name ran: the reader returns nothing, never 0
    run.trace = profile.Trace(window_s=1.0, busy_s=0.25, kernel_s={})
    assert read("k1_roofline", run) is None


def test_comparison_counts():
    a = {"xStart": np.array([1, 2, 3]), "group": np.array([0, 0, 1])}
    b = {"xStart": np.array([1, 5]), "group": np.array([0, 0])}
    assert check.rows_differing(a, b, ("xStart",)) == 2
    assert check.rows_differing(a, b, ("group",)) == 1
    assert check.lines_differing(b"a\nb\nc\n", b"a\nB\nc\n") == 1
    assert check.lines_differing(b"a\nb\n", b"a\nb\nc\n") == 2
    assert check.lines_differing(b"x", b"x") == 0
    assert check.verdict({k: 0 for k in check.LIMITS})
    assert not check.verdict({**{k: 0 for k in check.LIMITS},
                              "file_lines_differing": 1})
