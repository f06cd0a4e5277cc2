"""The port's on-device family clustering (families/device.py), run on the
CPU, against the JAX package's forced device path, the oracle union-find
and the port's streamed host path; and the conditions under which
families/cluster.py takes it, which are the reference's. Labels: exact
equality."""

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
    got = tcluster.cluster_families(frag, cfg, self_cmp, device_min_edges=0,
                                    device="cpu")
    want = jcluster.cluster_families(frag, _ref(cfg), self_cmp,
                                     device_min_edges=0)
    host = tcluster.cluster_families(frag, cfg, self_cmp,
                                     device_min_edges=1 << 62, device="cpu")
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)
    assert np.array_equal(got, torc.cluster_families(frag, cfg, self_cmp))
    return got


@pytest.fixture
def device_calls(monkeypatch):
    """Records each call of the device path (its device), then runs it."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[7])
        return cluster_families_device(*args, **kw)

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
    for min_edges, path in ((0, 1), (1 << 62, 0)):
        with trace.job() as job_id:
            lab = tcluster.cluster_families(frag, Config(), True,
                                            device_min_edges=min_edges,
                                            device="cpu")
        assert np.array_equal(lab, np.arange(5, dtype=np.int32))
        assert _propagate_counters(job_id) == [
            {"path": path, "edges": 0, "rounds": 0}]


def test_env_switch_on_a_cpu_device_keeps_the_host_path(monkeypatch,
                                                        device_calls):
    frag = random_frags(5000, 10)
    cfg = Config(proximity=5, len_ratio=0.9)
    *_, total, _ = tcluster._edge_ranges(frag, cfg, True)
    assert tcluster.DEVICE_MIN_EDGES <= total <= tcluster.DEVICE_EDGE_CAP
    monkeypatch.setenv("REPKILLER_DEVICE_CLUSTER", "1")
    got = tcluster.cluster_families(frag, cfg, True, device="cpu")
    assert device_calls == []
    assert np.array_equal(got, jcluster.cluster_families(frag, _ref(cfg), True))


def test_env_switch_on_cuda_takes_the_device_path(monkeypatch, device_calls):
    """On a CUDA device the switch, read on every call, picks the device
    path for a table in range, which raises without a GPU; unset, or
    below DEVICE_MIN_EDGES, the host path runs and nothing raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    big, small = random_frags(5000, 10), random_frags(300, 7)
    cfg = Config(proximity=5, len_ratio=0.9)
    want = tcluster.cluster_families(big, cfg, True, device="cpu")
    monkeypatch.delenv("REPKILLER_DEVICE_CLUSTER", raising=False)
    assert np.array_equal(tcluster.cluster_families(big, cfg, True), want)
    monkeypatch.setenv("REPKILLER_DEVICE_CLUSTER", "0")
    assert np.array_equal(tcluster.cluster_families(big, cfg, True), want)
    monkeypatch.setenv("REPKILLER_DEVICE_CLUSTER", "1")
    assert np.array_equal(tcluster.cluster_families(small, cfg, True),
                          torc.cluster_families(small, cfg, True))
    assert device_calls == []
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcluster.cluster_families(big, cfg, True, device="cuda")
    assert device_calls == ["cuda"]


def test_forced_device_path_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frag = random_frags(300, 7)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcluster.cluster_families(frag, Config(), True, device_min_edges=0)


def test_edge_cap_keeps_the_host_path(monkeypatch, device_calls):
    frag = random_frags(800, 8)
    cfg = Config()
    *_, total, _ = tcluster._edge_ranges(frag, cfg, False)
    monkeypatch.setattr(tcluster, "DEVICE_EDGE_CAP", total - 1)
    got = tcluster.cluster_families(frag, cfg, False, device_min_edges=0,
                                    device="cpu")
    assert device_calls == []
    monkeypatch.setattr(tcluster, "DEVICE_EDGE_CAP", total)
    assert np.array_equal(tcluster.cluster_families(
        frag, cfg, False, device_min_edges=0, device="cpu"), got)
    assert device_calls == ["cpu"]
    assert np.array_equal(got, torc.cluster_families(frag, cfg, False))


def test_length_guard_keeps_the_host_path(device_calls):
    """Lengths whose product with 100 leaves int32 take the host path, as
    in the reference."""
    frag = random_frags(300, 7)
    frag["length"] = frag["length"].copy()
    frag["length"][:5] = (1 << 31) // 100
    cfg = Config(len_ratio=0.0)
    got = tcluster.cluster_families(frag, cfg, True, device_min_edges=0,
                                    device="cpu")
    assert device_calls == []
    assert np.array_equal(got, torc.cluster_families(frag, cfg, True))
    frag["length"][:5] = (1 << 31) // 100 - 1
    assert np.array_equal(tcluster.cluster_families(
        frag, cfg, True, device_min_edges=0, device="cpu"), got)
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
