"""The port's trace recorder (repkiller_tpu_torch/utils/trace.py) and its
spans at the layer boundaries: nesting, parents and job ids; counters on
the innermost span and in the totals; span times on the caller's clock;
the ring's bound; one thread's spans apart from another's; the spans that
one call of each layer gives, on the CPU. The case marked ``cuda`` runs
on a card under ``torch.profiler``. This file imports no JAX."""

import collections
import io
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repkiller_tpu_torch import api, device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
from repkiller_tpu_torch.families import cluster as tcluster
from repkiller_tpu_torch.io import codec, fasta, native
from repkiller_tpu_torch.utils import synth, trace

from _torch_threads import one_torch_thread  # noqa: F401

RKBENCH = Path(__file__).resolve().parent.parent / "rkbench"
CFG = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=256)
FAMILIES = {"families": 1, "families.edges": 1, "families.propagate": 1}
# spans that time the device too (CUDA events), on a card
DEVICE_SPANS = {"compare", "seeds", "extend", "merge", "copy_out",
                "sharded.index", "sharded.hits", "sharded.regroup",
                "sharded.extend", "sharded.merge", "sharded.copy_out"}


@pytest.fixture(scope="module")
def genome():
    return synth.plant(12000, [(300, 3, 0.02, 1), (150, 4, 0.0, 1)], seed=5)


def _job(fn):
    """``fn()`` inside a trace job -> (its result, the job's spans other
    than the job's own)."""
    with trace.job() as job_id:
        out = fn()
    return out, [s for s in trace.spans()
                 if s["job"] == job_id and s["id"] != job_id]


def _names(spans) -> dict:
    return dict(collections.Counter(s["name"] for s in spans))


def test_nesting_parents_and_job_ids():
    rec = trace.Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
    with rec.job() as j:
        with rec.span("read") as r:
            pass
        with rec.span("compare") as cmp:
            with rec.span("seeds") as s:
                pass
        with rec.span("write") as w:
            pass
    by_id = {s["id"]: s for s in rec.spans()}
    assert [by_id[i]["parent"] for i in (a, b, c)] == [None, a, b]
    assert {by_id[i]["job"] for i in (a, b, c)} == {a}
    assert by_id[j]["name"] == "job" and by_id[j]["parent"] is None
    assert [by_id[i]["parent"] for i in (r, cmp, s, w)] == [j, j, cmp, j]
    assert {by_id[i]["job"] for i in (j, r, cmp, s, w)} == {j}
    # finished spans in the order they ended
    assert [s["id"] for s in rec.spans()] == [c, b, a, r, s, cmp, w, j]
    assert all(s["rank"] is None for s in rec.spans())


def test_job_gives_read_compare_and_write_one_id(genome, tmp_path):
    path = tmp_path / "g.fa"
    path.write_text(">g\n" + codec.decode(genome.codes) + "\n")

    def run():
        seqs = fasta.read_fasta(str(path))
        res = api.Result(frag=tdevice.compare(seqs.codes, None, CFG, "cpu"),
                         cfg=CFG, x=seqs)
        res.write_csv(str(tmp_path / "o.frags.csv"))
        return res

    _, spans = _job(run)
    names = _names(spans)
    assert {"io.read_fasta", "compare", "seeds", "report.csv"} <= set(names)
    assert len({s["job"] for s in spans}) == 1
    # the same calls without a job: a job per outermost span
    with trace.span("mark") as mark:
        pass
    seqs = fasta.read_fasta(str(path))
    tdevice.compare(seqs.codes, None, CFG, "cpu")
    new = [s for s in trace.spans() if s["id"] > mark]
    roots = {s["id"]: s["name"] for s in new if s["parent"] is None}
    assert sorted(roots.values()) == ["compare", "io.read_fasta"]
    assert {s["job"] for s in new} == set(roots)


def test_counters_go_to_the_innermost_span_and_the_totals():
    rec = trace.Recorder()
    rec.count("edges", 5)                    # no span open: totals only
    with rec.span("outer") as o:
        rec.count("rows", 2)
        with rec.span("inner") as i:
            rec.count("rows", 3)
            rec.count("rounds")
        rec.count("rows", 4)
    by_id = {s["id"]: s for s in rec.spans()}
    assert by_id[o]["counters"] == {"rows": 6}
    assert by_id[i]["counters"] == {"rows": 3, "rounds": 1}
    assert rec.totals() == {"edges": 5, "rows": 9, "rounds": 1}


def test_span_times_lie_inside_the_callers_window():
    rec = trace.Recorder()
    before = time.perf_counter()
    with rec.span("outer"):
        with rec.span("inner"):
            time.sleep(0.01)
    after = time.perf_counter()
    inner, outer = rec.spans()
    assert before <= outer["t0"] <= inner["t0"] < inner["t1"] \
        <= outer["t1"] <= after
    assert inner["t1"] - inner["t0"] >= 0.01


def test_the_ring_keeps_the_newest_spans_and_counts_the_dropped():
    rec = trace.Recorder(capacity=4)
    ids = []
    for i in range(10):
        with rec.span(f"s{i}") as sid:
            ids.append(sid)
    assert [s["id"] for s in rec.spans()] == ids[-4:]
    assert rec.dropped() == 6
    assert trace.RING == 65536


def test_threads_keep_their_own_stacks_and_lose_no_count():
    """Eight threads, more than this machine's share of cores, open nested
    spans and count into one recorder with a short switch interval: every
    parent is a span of the same thread and the totals are exact."""
    rec = trace.Recorder()
    n_threads, n_iter = 8, 300
    parents = {}

    def work(t):
        for _ in range(n_iter):
            with rec.span(f"t{t}") as outer:
                with rec.span(f"t{t}.inner") as inner:
                    rec.count("hits", 2)
                parents[inner] = (t, outer)
            rec.count("rounds")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert rec.totals() == {"hits": 2 * n_threads * n_iter,
                            "rounds": n_threads * n_iter}
    by_id = {s["id"]: s for s in rec.spans()}
    for inner, (t, outer) in parents.items():
        assert by_id[inner]["parent"] == outer
        assert by_id[inner]["name"] == f"t{t}.inner"
        assert by_id[outer]["name"] == f"t{t}"
        assert by_id[inner]["counters"] == {"hits": 2}


def test_device_compare_spans(genome):
    frag, spans = _job(lambda: tdevice.compare(genome.codes, None, CFG,
                                                 "cpu"))
    assert _names(spans) == {"compare": 1, "seeds": 1, "extend": 2,
                             "merge": 1, "copy_out": 1, **FAMILIES}
    by_name = {s["name"]: s for s in spans}
    cmp = by_name["compare"]["id"]
    assert {s["parent"] for s in spans if s["name"] in
            ("seeds", "extend", "merge", "copy_out", "families")} == {cmp}
    assert by_name["families.edges"]["parent"] == by_name["families"]["id"]
    counts = by_name["copy_out"]["counters"]
    assert counts["fragments"] == frag["xStart"].shape[0] > 0
    assert counts["hits"] >= counts["seeds"] > 0
    assert all(s["device_s"] is None for s in spans)       # no card here


def test_sharded_spans(genome):
    frag, spans = _job(lambda: compare_sharded(
        genome.codes, None, CFG, make_mesh(1, 1, devices=["cpu"])))
    assert _names(spans) == {
        "compare": 1, "sharded.index": 1, "sharded.hits": 1,
        "sharded.regroup": 2, "sharded.extend": 2, "sharded.merge": 1,
        "sharded.copy_out": 1, **FAMILIES}
    by_name = {s["name"]: s for s in spans}
    counts = by_name["sharded.copy_out"]["counters"]
    assert counts["fragments"] == frag["xStart"].shape[0] > 0
    assert counts["hits"] >= counts["seeds"] > 0
    moved = [s["counters"].get("collective_bytes", 0) for s in spans]
    assert sum(moved) > 0
    assert not {s["name"] for s in spans
                if "collective_bytes" in s["counters"]} - {
        "sharded.regroup", "sharded.extend", "sharded.merge"}


@pytest.mark.parametrize("min_fragments,path", [(1 << 62, 0), (0, 1)],
                         ids=["host", "device"])
@pytest.mark.parametrize("chunk", [1 << 22, 4])
def test_cluster_families_spans(genome, min_fragments, path, chunk):
    """The layer's spans and counters on either path: ``blocks`` counts
    the edge blocks of round 1, one for a table under ``chunk`` edges."""
    frag = tdevice.compare(genome.codes, None, CFG, "cpu")
    lab, spans = _job(lambda: tcluster.cluster_families(
        frag, CFG, True, chunk, device_min_fragments=min_fragments,
        device="cpu"))
    assert _names(spans) == FAMILIES
    by_name = {s["name"]: s for s in spans}
    assert by_name["families"]["counters"] == {"fragments": lab.shape[0]}
    counts = by_name["families.propagate"]["counters"]
    assert counts["path"] == path and counts["rounds"] >= 1
    assert counts["edges"] > 0
    *_, total, _ = tcluster._edge_ranges(frag, CFG, True)
    most = -(-total // chunk)          # the device path's, exactly
    assert 1 <= counts["blocks"] <= most and (path == 0 or counts["blocks"]
                                              == most)
    assert (counts["blocks"] > 1) == (chunk < total)


def test_writer_and_reader_spans(genome, tmp_path):
    path = tmp_path / "g.fa"
    path.write_text(">g\n" + codec.decode(genome.codes) + "\n")
    seqs, spans = _job(lambda: fasta.read_fasta(str(path)))
    assert _names(spans) == ({"io.read_fasta": 1, "io.scan_names": 1}
                             if native.available() else {"io.read_fasta": 1})
    read = next(s for s in spans if s["name"] == "io.read_fasta")
    assert read["counters"] == {"bytes": path.stat().st_size, "records": 1}
    res = api.Result(frag=tdevice.compare(seqs.codes, None, CFG, "cpu"),
                     cfg=CFG, x=seqs)
    n = res.n_fragments
    calls = {
        "report.csv": (lambda: res.write_csv(str(tmp_path / "o.csv")),
                       {"rows": n}),
        "report.summary": (lambda: res.write_family_summary(
            str(tmp_path / "o.families.csv")), {"rows": res.n_families}),
        "report.bed": (lambda: res.write_intervals(str(tmp_path / "o.bed")),
                       {}),
        "report.masked_fasta": (res.masked_fasta, {}),
    }
    for name, (call, want) in calls.items():
        out, spans = _job(call)
        assert _names(spans) == {name: 1}, name
        counts = spans[0]["counters"]
        assert want.items() <= counts.items(), (name, counts)
        assert counts["bytes"] > 0
        if name == "report.masked_fasta":
            assert counts["bytes"] == len(out) and counts["intervals"] > 0
        if name == "report.bed":
            assert counts["intervals"] == sum(len(v) for v in out.values())
        if name == "report.csv":
            assert counts["native"] == int(native.available())
            assert counts["threads"] == 1           # a small table


@pytest.mark.parametrize("records,n", [(2, 500), (1, 120_000),
                                       (3, 120_000)])
def test_csv_span_counts_native_and_threads(records, n, tmp_path):
    """"report.csv" on a path: ``native`` 1 whenever the library is there,
    multi-record tables too; ``threads``, the threads that formatted
    rows, 1 on a small table and 1 to 8 on a large one."""
    lengths = np.full(records, 40_000)
    offs = np.arange(records) * 40_032
    seqs = fasta.SeqSet(codes=np.zeros(int(offs[-1]) + 40_000, np.uint8),
                        names=[f"c{i}" for i in range(records)],
                        offsets=offs, lengths=lengths)
    rng = np.random.default_rng(n)
    start = (offs[rng.integers(0, records, n)]
             + rng.integers(0, 39_000, n)).astype(np.int32)
    ln = rng.integers(1, 1000, n).astype(np.int32)
    frag = {"xStart": start, "xEnd": start + ln - 1, "yStart": start,
            "yEnd": start + ln - 1, "strand": np.zeros(n, np.int32),
            "length": ln, "score": ln, "idents": ln // 2,
            "group": rng.integers(0, 50, n).astype(np.int32)}
    res = api.Result(frag=frag, cfg=CFG, x=seqs)
    path = tmp_path / "o.csv"
    for coords in ("concat", "record"):
        _, spans = _job(lambda: res.write_csv(str(path), coords=coords))
        assert _names(spans) == {"report.csv": 1}
        counts = spans[0]["counters"]
        assert counts["rows"] == n and counts["bytes"] == path.stat().st_size
        assert counts["native"] == int(native.available())
        assert 1 <= counts["threads"] <= 8
        if n < 8192:
            assert counts["threads"] == 1


def test_bed_span_counts_the_intervals_split_at_record_boundaries():
    """``split`` on "report.bed": the merged intervals that straddle a
    record boundary and so give more than one row. X and Y are the same
    two records of 300 and 400 bases (offsets 0 and 332); in X one
    interval straddles the spacer and one lies in a record, in Y one runs
    from the spacer into the second record (one row) and one lies in a
    record. On one record of the same codes none splits."""
    codes = np.zeros(732, np.uint8)
    two = fasta.SeqSet(codes=codes, names=["a", "b"],
                       offsets=np.array([0, 332]), lengths=np.array([300, 400]))
    frag = {"xStart": np.array([280, 100], np.int32),
            "xEnd": np.array([350, 120], np.int32),
            "yStart": np.array([310, 500], np.int32),
            "yEnd": np.array([340, 560], np.int32),
            "strand": np.zeros(2, np.int32), "score": np.ones(2, np.int32),
            "length": np.ones(2, np.int32), "group": np.zeros(2, np.int32)}
    for seqs, want in ((two, 1), (fasta.from_codes(codes, "a"), 0)):
        res = api.Result(frag=frag, cfg=Config(), x=seqs, y=seqs)
        out = io.StringIO()
        iv, spans = _job(lambda: res.write_intervals(out))
        assert _names(spans) == {"report.bed": 1}
        assert spans[0]["counters"]["split"] == want
        if seqs is two:
            assert want == sum(int(np.count_nonzero(
                (v[:, 0] < 300) & (v[:, 1] >= 332))) for v in iv.values())
        n_iv = sum(len(v) for v in iv.values())
        assert len(out.getvalue().splitlines()) == n_iv + want


def test_spans_are_profiler_ranges_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile
    rec = trace.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with rec.span("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {trace.PREFIX + "outer", trace.PREFIX + "inner"} <= names


def test_a_cuda_device_without_a_gpu_records_no_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = trace.Recorder()
    with rec.span("x", device="cuda"):
        pass
    assert rec.spans()[0]["device_s"] is None


@pytest.mark.cuda
def test_on_the_card_under_the_profiler(genome):
    """On the card, under torch.profiler: every span of a job is a
    repkiller.* range, every device span has its device time, the
    extension spans carry the kernel launches, and the benchmark's trace
    reduction counts no repkiller.* range as device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile as torch_profile
    sys.path.insert(0, str(RKBENCH))
    from harness import profile

    gpu = torch.device("cuda", 0)
    cfg = Config(k=12, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 14, max_extend=512)
    tdevice.compare(genome.codes, None, cfg, gpu)     # builds the kernels
    before = trace.totals().get("k1_launches", 0)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        with torch.profiler.record_function(profile.SPAN + "job"):
            _, spans = _job(lambda: (
                tdevice.compare(genome.codes, None, cfg, gpu),
                compare_sharded(genome.codes, None, cfg,
                                make_mesh(1, 1, devices=[gpu]))))
    names = {e.name for e in prof.events()}
    assert {trace.PREFIX + s["name"] for s in spans} <= names
    timed = [s for s in spans if s["name"] in DEVICE_SPANS]
    assert len(timed) == 15
    assert all(s["device_s"] is not None and s["device_s"] > 0
               for s in timed)
    for cmp in (s for s in timed if s["name"] == "compare"):
        inside = sum(s["device_s"] for s in timed
                     if s["parent"] == cmp["id"])
        assert 0 < inside <= cmp["device_s"] * 1.001 + 1e-5
    launched = trace.totals()["k1_launches"] - before
    assert launched > 0
    assert sum(s["counters"].get("k1_launches", 0) for s in spans
               if s["name"] in ("extend", "sharded.extend")) == launched
    reduced = profile.from_profiler(prof)
    assert not [n for n in reduced.kernel_s if n.startswith(trace.PREFIX)]
    assert reduced.device_s("gotoh") > 0
    assert not [n for n in reduced.kernel_s if "repkiller" in n]
    assert np.isfinite(reduced.busy_s) and reduced.busy_s > 0
