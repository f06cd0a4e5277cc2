"""The port's on-device family clustering (families/device.py), run on the
CPU, against the JAX package's forced device path, the oracle union-find
and the port's streamed host path: its interval table against the host's,
its blocked edge expansion at several block sizes, and the rule by which
families/cluster.py takes it. Labels and tables: exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.families import cluster as jcluster
from repkiller_tpu_torch import api, device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist import sharded as tsharded, windows as twindows
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.families import cluster as tcluster
from repkiller_tpu_torch.families import device as tfdevice
from repkiller_tpu_torch.families.device import cluster_families_device
from repkiller_tpu_torch.oracle import pipeline as torc
from repkiller_tpu_torch.report import csv_writer as tcsv
from repkiller_tpu_torch.utils import synth, trace

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import pileup_frags, random_frags

CONFIGS = [Config(), Config(proximity=100, len_ratio=0.0),
           Config(proximity=5, len_ratio=0.9)]


def _ref(cfg: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def _all_paths_agree(frag, cfg, self_cmp):
    got = tcluster.cluster_families(frag, cfg, self_cmp,
                                    device_min_fragments=0, device="cpu")
    want = jcluster.cluster_families(frag, _ref(cfg), self_cmp,
                                     device_min_edges=0)
    host = tcluster.cluster_families(frag, cfg, self_cmp,
                                     device_min_fragments=1 << 62,
                                     device="cpu")
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)
    assert np.array_equal(got, torc.cluster_families(frag, cfg, self_cmp))
    return got


@pytest.fixture
def device_calls(monkeypatch):
    """Records each call of the device path (its device), then runs it."""
    calls = []

    def spy(frag, cfg, self_cmp, device, *args):
        calls.append(str(device))
        return cluster_families_device(frag, cfg, self_cmp, device, *args)

    monkeypatch.setattr(tcluster, "cluster_families_device", spy)
    return calls


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "prox100", "ratio90"])
@pytest.mark.parametrize("seed,n,self_cmp", [
    (7, 300, True), (8, 800, False), (9, 0, True),
])
def test_forced_device_path_matches_reference(seed, n, self_cmp, cfg,
                                              device_calls):
    _all_paths_agree(random_frags(n, seed), cfg, self_cmp)
    assert device_calls == (["cpu"] if n else [])


def test_forced_device_path_dense_pileup(device_calls):
    lab = _all_paths_agree(pileup_frags(), Config(proximity=50), True)
    assert device_calls == ["cpu"]
    assert 1 < np.unique(lab).shape[0] < lab.shape[0]


@pytest.mark.parametrize("cfg", [Config(), Config(proximity=5, len_ratio=0.9),
                                 Config(proximity=5, len_ratio=0.97)],
                         ids=["default", "ratio90", "ratio97"])
def test_forced_device_path_over_a_million_edges(cfg):
    """Both paths on a table of over 10^6 edges: the same labels, and the
    same kept edges in their "families.propagate" spans' counters."""
    frag = random_frags(5000, 10)
    *_, total, _ = tcluster._edge_ranges(frag, cfg, True)
    assert total > 10 ** 6
    with trace.job() as job_id:
        _all_paths_agree(frag, cfg, True)
    device, host = _propagate_counters(job_id)
    assert device["path"] == 1 and host["path"] == 0
    for c in (device, host):
        assert 0 < c["edges"] <= total and c["rounds"] >= 2
    assert device["edges"] == host["edges"]
    assert device["blocks"] == host["blocks"] == 1


def _propagate_counters(job_id: int) -> list:
    """The counters of job ``job_id``'s "families.propagate" spans, in the
    order the spans closed."""
    return [s["counters"] for s in trace.spans()
            if s["job"] == job_id and s["name"] == "families.propagate"]


def test_no_edges_gives_every_fragment_its_own_family():
    """Five fragments too far apart to link: each path gives every one its
    own family and counts no edge and no round."""
    starts = np.arange(5, dtype=np.int32) * 1000
    frag = {"xStart": starts, "xEnd": starts + 99, "yStart": starts + 50000,
            "yEnd": starts + 50099, "strand": np.zeros(5, np.int32),
            "length": np.full(5, 100, np.int32),
            "score": np.full(5, 100, np.int32),
            "idents": np.full(5, 100, np.int32)}
    for min_fragments, path in ((0, 1), (1 << 62, 0)):
        with trace.job() as job_id:
            lab = tcluster.cluster_families(frag, Config(), True,
                                            device_min_fragments=min_fragments,
                                            device="cpu")
        assert np.array_equal(lab, np.arange(5, dtype=np.int32))
        assert _propagate_counters(job_id) == [
            {"path": path, "blocks": 0, "edges": 0, "rounds": 0}]


def _tied_frags(n: int = 60, seed: int = 4):
    """Fragments whose intervals tie in (space, start, end) across
    fragments and across their x and y copies: starts from three values,
    lengths from two."""
    rng = np.random.default_rng(seed)
    xs = rng.choice([0, 40, 80], n).astype(np.int32)
    ys = rng.choice([0, 40, 80], n).astype(np.int32)
    ln = rng.choice([50, 60], n).astype(np.int32)
    rev = rng.integers(0, 2, n).astype(np.int32)
    frag = {"xStart": xs, "xEnd": xs + ln - 1,
            "yStart": np.where(rev == 1, ys + ln - 1, ys).astype(np.int32),
            "yEnd": np.where(rev == 1, ys, ys + ln - 1).astype(np.int32),
            "strand": rev, "length": ln,
            "score": np.full(n, 100, np.int32),
            "idents": np.full(n, 90, np.int32)}
    return torc.canonical_sort(frag)


def _one_frag():
    """One fragment whose x and y copies overlap."""
    vals = {"xStart": 100, "xEnd": 199, "yStart": 150, "yEnd": 249,
            "strand": 0, "length": 100, "score": 400, "idents": 100}
    return {f: np.array([v], np.int32) for f, v in vals.items()}


TABLES = {
    "self": lambda: (random_frags(800, 8), Config(), True),
    "pair": lambda: (random_frags(800, 8), Config(), False),
    "empty": lambda: (random_frags(0, 9), Config(), True),
    "single": lambda: (_one_frag(), Config(), True),
    "ties_self": lambda: (_tied_frags(), Config(), True),
    "ties_pair": lambda: (_tied_frags(), Config(len_ratio=0.9), False),
    "pileup": lambda: (pileup_frags(), Config(proximity=50), True),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_device_interval_table_matches_host(table):
    """The interval table built with torch ops (order, neighbour ranges,
    counts, offsets, running sum, edge total) equals _edge_ranges'."""
    frag, cfg, self_cmp = TABLES[table]()
    want = tcluster._edge_ranges(frag, cfg, self_cmp)
    got = tfdevice.edge_ranges_device(frag, cfg, self_cmp, "cpu")
    names = ("fidx", "counts", "offs", "lo", "lens", "pct", "total", "csum")
    for name, w, g in zip(names, want, got):
        g = g.numpy() if torch.is_tensor(g) else g
        assert np.array_equal(np.asarray(w), np.asarray(g)), name
    if table == "single":
        assert want[6] == 1          # its own x and y copies overlap
    if table.startswith("ties"):
        assert want[6] > 0


def _small_pileup():
    return {f: v[:80] for f, v in pileup_frags().items()}


@pytest.mark.parametrize("chunk,kept_blocks", [
    (1, 8), (7, 8), (7, 1 << 40), (1 << 22, 8), (1 << 22, 0)],
    ids=["1", "7", "7-kept", "2^22", "2^22-tiny-budget"])
@pytest.mark.parametrize("table", ["self", "pair", "pileup"])
def test_blocked_expansion_matches_host(chunk, kept_blocks, table,
                                        monkeypatch):
    """The device path at several edge-block sizes gives the host path's
    labels and kept edges, in ceil(total / chunk) blocks a round. While
    the kept edges fit KEPT_BLOCKS blocks the blocks are expanded once;
    past that (a tiny budget) every round expands them anew."""
    frag, cfg, self_cmp = {
        "self": lambda: (random_frags(120, 21), Config(), True),
        "pair": lambda: (random_frags(160, 22), Config(), False),
        "pileup": lambda: (_small_pileup(), Config(proximity=50), True),
    }[table]()
    *_, total, _ = tcluster._edge_ranges(frag, cfg, self_cmp)
    expanded = []
    block = tfdevice.edge_block

    def spy(*args):
        expanded.append(args[-2])
        return block(*args)

    monkeypatch.setattr(tfdevice, "edge_block", spy)
    monkeypatch.setattr(tfdevice, "KEPT_BLOCKS", kept_blocks)
    with trace.job() as job_id:
        got = tcluster.cluster_families(frag, cfg, self_cmp, chunk, 0,
                                        device="cpu")
        host = tcluster.cluster_families(frag, cfg, self_cmp, chunk,
                                         1 << 62, device="cpu")
    assert np.array_equal(got, host)
    assert np.array_equal(got, torc.cluster_families(frag, cfg, self_cmp))
    device, host_c = _propagate_counters(job_id)
    blocks = -(-total // chunk)
    assert total > 100 and device["blocks"] == blocks
    assert device["edges"] == host_c["edges"] > 0
    cached = device["edges"] <= kept_blocks * chunk
    assert len(expanded) == blocks * (1 if cached else device["rounds"])
    assert expanded[:blocks] == list(range(0, total, chunk))


def test_default_rule_on_a_cpu_device_keeps_the_host_path(device_calls):
    """On a CPU device the default rule never takes the device path,
    whatever the table's size."""
    n = tcluster.DEVICE_MIN_FRAGMENTS
    frag, cfg = random_frags(n, 10, L=80 * n), Config()
    got = tcluster.cluster_families(frag, cfg, True, device="cpu")
    assert device_calls == []
    assert np.array_equal(got, jcluster.cluster_families(frag, _ref(cfg), True))


@pytest.mark.parametrize("available", [False, True])
def test_default_rule_on_cuda(monkeypatch, available):
    """On a CUDA device the default rule takes the device path from
    DEVICE_MIN_FRAGMENTS fragments when a GPU is there (the spy runs it
    on the CPU), and the host path below it or without a GPU, where
    nothing raises; forcing the device path without a GPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    calls = []

    def spy(frag, cfg, self_cmp, device, *args):
        calls.append(str(device))
        return cluster_families_device(frag, cfg, self_cmp, "cpu", *args)

    monkeypatch.setattr(tcluster, "cluster_families_device", spy)
    threshold = tcluster.DEVICE_MIN_FRAGMENTS
    big = random_frags(threshold, 10, L=80 * threshold)
    small = {f: v[:threshold - 1] for f, v in big.items()}
    cfg = Config()
    for frag in (small, big):
        assert np.array_equal(tcluster.cluster_families(frag, cfg, True),
                              torc.cluster_families(frag, cfg, True))
    assert calls == (["cuda"] if available else [])
    if not available:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cluster_families_device(small, cfg, True, "cuda", 1 << 22)


def test_forced_device_path_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frag = random_frags(300, 7)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcluster.cluster_families(frag, Config(), True,
                                  device_min_fragments=0)


def test_length_guard_keeps_the_host_path(device_calls):
    """Lengths whose product with 100 leaves int32 take the host path, as
    in the reference."""
    frag = random_frags(300, 7)
    frag["length"] = frag["length"].copy()
    frag["length"][:5] = (1 << 31) // 100
    cfg = Config(len_ratio=0.0)
    got = tcluster.cluster_families(frag, cfg, True, device_min_fragments=0,
                                    device="cpu")
    assert device_calls == []
    assert np.array_equal(got, torc.cluster_families(frag, cfg, True))
    frag["length"][:5] = (1 << 31) // 100 - 1
    assert np.array_equal(tcluster.cluster_families(
        frag, cfg, True, device_min_fragments=0, device="cpu"), got)
    assert device_calls == ["cpu"]


def _codes():
    return synth.plant(12000, [(300, 3, 0.02, 1), (150, 4, 0.0, 1)],
                       seed=5).codes


@pytest.mark.parametrize("caller", ["device.compare", "compare_streamed",
                                    "compare_sharded", "group_fragments"])
def test_callers_cluster_on_the_runs_device(caller, monkeypatch, tmp_path):
    """Each caller hands families/cluster.py the device its run used."""
    modules = {"device.compare": tdevice, "compare_streamed": twindows,
               "compare_sharded": tsharded, "group_fragments": api}
    seen = []

    def spy(frag, cfg, self_cmp, *args, device="cuda", **kw):
        seen.append(str(device))
        return tcluster.cluster_families(frag, cfg, self_cmp, *args,
                                         device=device, **kw)

    monkeypatch.setattr(modules[caller], "cluster_families", spy)
    cfg = Config(k=12, strands="fr")
    codes = _codes()
    if caller == "device.compare":
        frag = tdevice.compare(codes, None, cfg, "cpu")
    elif caller == "compare_streamed":
        frag = twindows.compare_streamed(codes, None, cfg, window=4096,
                                         device="cpu")
    elif caller == "compare_sharded":
        frag = tsharded.compare_sharded(codes, None, cfg,
                                        make_mesh(1, 1, devices=["cpu"]))
    else:
        want = tdevice.compare(codes, None, cfg, "cpu")
        path = str(tmp_path / "f.csv")
        tcsv.write_frags_csv(want, path)
        frag = api.group_fragments(path, cfg, device="cpu")
        assert np.array_equal(frag["group"], want["group"])
    assert seen == ["cpu"]
    assert frag["xStart"].shape[0] > 0
