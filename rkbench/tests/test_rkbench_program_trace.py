"""The readers of the program's own trace (``harness/program_trace.py``):
they sum only the spans of the measured window, divide by the jobs done,
and give None where the spans are absent or the window lost some to the
ring; every metric that reads the trace has a reader file and a manifest
entry; and a traced run on the CPU reports them beside the benchmark's
outside spans."""

import sys

import pytest

from _tiny import run_tiny, tiny_cell
from harness import check, driver, manifest, program_trace
from repkiller_tpu_torch.utils import trace

PROGRAM_METRICS = {
    "csv_write_s": "report", "summary_write_s": "report",
    "bed_write_s": "report", "masked_fasta_s": "report",
    "fasta_names_s": "io", "families_propagate_s": "families",
    "families_rounds": "families", "sharded_seeds_s": "sharded",
    "sharded_extend_s": "sharded", "sharded_merge_s": "sharded",
}


def _run(jobs, done=None):
    """A Run whose measured window is ``jobs`` [(start, end)]; ``done``:
    how many of them completed (all by default)."""
    done = len(jobs) if done is None else done
    recs = [driver.JobRecord(s, e, 1000, i < done, 0)
            for i, (s, e) in enumerate(jobs)]
    return driver.Run(manifest.cell("ecoli_k12_self.banded"), 1.0, recs, 0)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder of 8 spans in place of the process's."""
    rec = trace.Recorder(capacity=8)
    monkeypatch.setattr(trace, "spans", rec.spans)
    monkeypatch.setattr(trace, "dropped", rec.dropped)
    return rec


def _span(rec, name, t0, t1, **counters):
    """A finished span of ``rec`` with the given times and counters."""
    with rec.span(name):
        for k, v in counters.items():
            rec.count(k, v)
    r = rec._ring[-1]
    r.t0, r.t1 = t0, t1


def test_only_the_windows_spans_count_divided_by_jobs_done(recorder):
    _span(recorder, "report.bed", 0.0, 1.0, intervals=5)       # warm-up
    _span(recorder, "report.bed", 10.0, 10.5, intervals=7)
    _span(recorder, "report.bed", 12.0, 12.25, intervals=9)
    _span(recorder, "report.csv", 12.5, 12.75)
    _span(recorder, "report.bed", 30.0, 31.0, intervals=11)    # profiled
    run = _run([(10.0, 11.0), (11.0, 13.0)])
    assert program_trace.host_s(run, "report.bed") == pytest.approx(0.375)
    assert program_trace.host_s(run, "report.bed", "report.csv") == \
        pytest.approx(0.5)
    assert program_trace.counter(run, "report.bed", "intervals") == 8
    run = _run([(10.0, 11.0), (11.0, 13.0)], done=1)
    assert program_trace.host_s(run, "report.bed") == pytest.approx(0.75)


def test_absent_spans_read_none(recorder):
    _span(recorder, "report.csv", 10.0, 10.5)
    run = _run([(10.0, 11.0)])
    assert program_trace.host_s(run, "report.bed") is None
    assert program_trace.counter(run, "report.csv", "rows") is None
    assert program_trace.host_s(_run([]), "report.csv") is None


def test_spans_without_device_time_read_none(recorder):
    _span(recorder, "sharded.merge", 10.0, 10.5)
    run = _run([(10.0, 11.0)])
    assert program_trace.host_s(run, "sharded.merge") == pytest.approx(0.5)
    assert program_trace.device_s(run, "sharded.merge") is None
    recorder._ring[-1].device_s = 0.25
    assert program_trace.device_s(run, "sharded.merge") == pytest.approx(0.25)


def test_a_window_that_lost_spans_reads_none(recorder):
    for i in range(10):                     # a ring of 8 drops the first 2
        _span(recorder, "report.csv", 10.0 + i, 10.5 + i)
    assert trace.dropped() == 2
    assert program_trace.host_s(_run([(10.0, 20.0)]), "report.csv") is None
    # spans leave the ring in the order they ended: a window that starts
    # after the oldest span kept ended lost nothing
    assert program_trace.host_s(_run([(12.5, 20.0)]), "report.csv") == \
        pytest.approx(3.5)


def test_a_program_without_the_trace_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repkiller_tpu_torch.utils.trace", None)
    assert program_trace.window_spans(_run([(0.0, 1.0)])) is None
    assert program_trace.host_s(_run([(0.0, 1.0)]), "report.csv") is None


def test_every_program_metric_has_a_reader_and_an_entry():
    entries = {e["name"]: e for e in manifest.load_manifest()["per_layer"]}
    for name, layer in PROGRAM_METRICS.items():
        assert callable(manifest.reader(name)), name
        e = entries[name]
        assert e["source"] == "program_span" and e["layer"] == layer
        assert e["moves"] == "throughput_mbp_s" and e["better"] == "lower"
        assert e["unit"] == ("rounds/job" if name == "families_rounds"
                             else "s/job")


@pytest.mark.parametrize("name,kw", [
    ("ecoli_k12_self.ungapped", {}),
    ("dmel_2l2r_mask.banded", {"length": 8000}),
])
def test_traced_run_reads_the_programs_spans(name, kw):
    """A traced run on the CPU reports every host metric of the program's
    trace that its cell lists (the device-time ones need a card), and the
    program's writer spans lie inside the benchmark's write span."""
    cell = tiny_cell(name, **kw)
    run, numbers = run_tiny(cell, trace=True)
    assert check.verdict(numbers)
    got = manifest.read_metrics(cell.per_layer, run)
    listed = {e["name"] for e in cell.per_layer} & set(PROGRAM_METRICS)
    host = {n for n in listed if not n.startswith("sharded_")}
    assert host <= set(got)
    assert not listed - host & set(got)
    writes = sum(got[n]["value"] for n in ("csv_write_s", "summary_write_s",
                                           "bed_write_s", "masked_fasta_s")
                 if n in got)
    assert 0 < writes <= got["write_s"]["value"]
    assert 0 < got["families_propagate_s"]["value"] <= \
        got["families_s"]["value"]
