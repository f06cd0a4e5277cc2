"""The sharded backend of the torch port (dist/sharded.compare_sharded)
against the JAX package's, case for case as tests/dist/test_sharded.py:
the JAX side runs on the 8-virtual-device CPU mesh of tests/conftest.py,
the port on a one-process mesh of as many CPU bodies. Output must be
bit-identical (every FRAG_FIELDS column and "group") on every mesh shape;
each host check raises the reference's message."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repkiller_tpu import api as japi
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.dist.mesh import make_mesh as j_make_mesh
from repkiller_tpu.dist.sharded import compare_sharded as j_compare_sharded
from repkiller_tpu.io import codec as jcodec
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import api
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist import mesh as tmesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = Config(k=12, strands="fr", hit_capacity=1 << 13, max_extend=256)

MESHES = [(1, 1), (2, 1), (1, 2), (4, 2), (2, 4), (8, 1)]


def _ref(cfg: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def _cpu_mesh(shape):
    return tmesh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _both(cx, cy, cfg, shape):
    """(port, JAX) compare_sharded on meshes of ``shape``."""
    got = compare_sharded(cx, cy, cfg, _cpu_mesh(shape))
    want = j_compare_sharded(cx, cy, _ref(cfg), j_make_mesh(*shape))
    return got, want


def _assert_frag_equal(got, want):
    assert set(got) == set(want)
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]), (
            f, got[f][:10], want[f][:10])


@pytest.mark.parametrize("shape", MESHES)
def test_self_invariant_over_mesh(shape):
    g = synth.plant(3000, [(120, 3, 0.05, 1), (80, 2, 0.0, 0)], seed=11)
    got, want = _both(g.codes, None, CFG, shape)
    _assert_frag_equal(got, want)
    _assert_frag_equal(got, orc.compare(g.codes, None, _ref(CFG)))
    assert got["xStart"].shape[0] > 0


@pytest.mark.parametrize("shape", [(2, 2), (8, 1), (1, 4)])
def test_cross_invariant_over_mesh(shape):
    rng = np.random.default_rng(5)
    cx = rng.integers(0, 4, 2500, dtype=np.uint8)
    cy = rng.integers(0, 4, 1700, dtype=np.uint8)
    cy[200:400] = cx[600:800]
    cy[900:1000] = jcodec.revcomp_codes(cx[1200:1300])
    got, want = _both(cx, cy, CFG, shape)
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0


@pytest.mark.parametrize("strands", ["r", "fr"])
def test_self_strand_selection_over_mesh(strands):
    cfg = CFG.replace(strands=strands)
    g = synth.plant(3000, [(120, 4, 0.04, 2), (80, 2, 0.0, 1)], seed=13)
    got, want = _both(g.codes, None, cfg, (2, 2))
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0
    if strands == "r":
        assert set(got["strand"].tolist()) == {1}


def test_banded_sharded_matches_jax():
    cfg = CFG.replace(extend_mode="banded", band=4)
    g = synth.plant(2000, [(100, 3, 0.04, 1)], seed=3)
    got, want = _both(g.codes, None, cfg, (4, 2))
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _same_error(cx, cy, cfg, shape):
    got = _error(lambda: compare_sharded(cx, cy, cfg, _cpu_mesh(shape)))
    want = _error(lambda: j_compare_sharded(cx, cy, _ref(cfg), j_make_mesh(*shape)))
    assert got == want
    return got


def test_overflow_detected_sharded():
    codes = np.zeros(400, dtype=np.uint8)  # poly-A hyper-repeat
    cfg = Config(k=8, max_occ=10000, hit_capacity=64 * 8, max_extend=128)
    assert "capacity" in _same_error(codes, None, cfg, (4, 2))


def test_indivisible_capacity_rejected():
    cfg = Config(hit_capacity=100)  # not divisible by 8
    assert "divisible" in _same_error(np.zeros(100, np.uint8), None, cfg, (4, 2))


def _frag_capacity_case():
    """Three 25 bp copies whose k=14 hits each thin to one seed at a
    bucket start: 3 seeds, 3 accepted fragments."""
    rng = np.random.default_rng(2)
    c = rng.integers(0, 4, 3000).astype(np.uint8)
    for a, b in ((320, 1500), (960, 2100), (640, 2600)):
        c[b:b + 25] = c[a:a + 25]
    return c, None, Config(k=14, strands="f", min_len=20, max_extend=128,
                           hit_capacity=256, seed_capacity=3), (1, 1)


def _shuffle_block_case():
    """Chunk 1 of a (1, 2) mesh is mostly poly-A, so its block for shard 0
    passes cap_blk while the shard itself stays within cap_shard; the
    poly-A k-mers pass max_occ and give no hits."""
    rng = np.random.default_rng(6)
    cx = rng.integers(0, 4, 4000).astype(np.uint8)
    cx[2200:3900] = 0
    cy = rng.integers(0, 4, 1000).astype(np.uint8)
    return cx, cy, Config(k=12, strands="f", hit_capacity=1 << 12,
                          max_extend=128), (1, 2)


# one input per host check, in the reference's order
CHECKS = {
    "hit-divisible": (lambda: (np.zeros(100, np.uint8), None,
                               Config(hit_capacity=100), (4, 2)),
                      "hit_capacity 100 must be divisible"),
    "seed-divisible": (lambda: (np.zeros(100, np.uint8), None,
                                Config(hit_capacity=64, seed_capacity=34), (2, 2)),
                       "seed_capacity 34 must be divisible"),
    "shard": (lambda: (np.zeros(3000, np.uint8), np.zeros(3000, np.uint8),
                       Config(k=12, strands="f", hit_capacity=1 << 12,
                              max_occ=1 << 30), (2, 2)),
              "index shard capacity"),
    "hit": (lambda: (np.zeros(400, np.uint8), None,
                     Config(k=8, max_occ=10000, hit_capacity=512,
                            max_extend=128), (8, 1)),
            "per-device hit capacity"),
    "shuffle-block": (_shuffle_block_case, "shuffle block overflow"),
    "window-seeds": (lambda: (synth.plant(3000, [(120, 3, 0.05, 1)], seed=11).codes,
                              None, CFG.replace(seed_capacity=8), (2, 1)),
                     "per-window seed capacity 4 (= seed_capacity 8 / 2 windows)"),
    "frag": (_frag_capacity_case, "frag capacity overflow"),
}


@pytest.mark.parametrize("check", list(CHECKS))
def test_host_check_messages(check):
    case, start = CHECKS[check]
    msg = _same_error(*case())
    assert msg.startswith(start), msg


def test_api_sharded_backend_matches_jax():
    """api.compare(backend="sharded") over the default mesh (one CPU body
    here) against the JAX package's over its 8 devices."""
    g = synth.plant(3000, [(120, 3, 0.05, 1), (80, 2, 0.0, 0)], seed=17)
    got = api.compare(g.codes, None, CFG, backend="sharded", device="cpu")
    want = japi.compare(g.codes, None, _ref(CFG), backend="sharded")
    _assert_frag_equal(got.frag, want.frag)
    mesh = _cpu_mesh((2, 2))
    again = api.compare(g.codes, None, CFG, backend="sharded", mesh=mesh)
    _assert_frag_equal(again.frag, want.frag)
    assert got.n_fragments > 0


def test_short_genome_is_empty():
    for codes in (np.zeros(5, np.uint8), np.zeros(0, np.uint8)):
        got = compare_sharded(codes, None, CFG, _cpu_mesh((2, 1)))
        want = j_compare_sharded(codes, None, _ref(CFG), j_make_mesh(2, 1))
        _assert_frag_equal(got, want)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synth.plant(2000, [(100, 3, 0.0, 0)], seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        compare_sharded(g.codes, None, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compare(g.codes, cfg=CFG, backend="sharded")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


@pytest.mark.parametrize("args,want", [
    ((None, None, 8), (4, 2)), ((None, None, 4), (2, 2)), ((None, None, 2), (2, 1)),
    ((None, None, 1), (1, 1)), ((2, None, 8), (2, 4)), ((None, 4, 8), (2, 4)),
    ((2, 2, 8), (2, 2)), ((1, 1, 8), (1, 1))])
def test_make_mesh_shapes_match_jax(args, want):
    """Default and partial shapes as the reference's make_mesh; a mesh
    smaller than the device list takes the leading devices."""
    n_data, n_shard, n = args
    devs = [f"cpu:{i}" for i in range(n)]
    got = tmesh.make_mesh(n_data, n_shard, devices=devs)
    ref = j_make_mesh(n_data, n_shard, devices=jax.devices()[:n])
    assert (got.n_data, got.n_shard) == want == (ref.shape["data"], ref.shape["shard"])
    assert [str(got.devices[b]) for b in got.bodies] == devs[: want[0] * want[1]]


@pytest.mark.parametrize("args", [(4, 4, 8), (9, 1, 8), (None, 3, 6), (1, 3, 8)])
def test_make_mesh_errors_match_jax(args):
    n_data, n_shard, n = args
    got = _error(lambda: tmesh.make_mesh(n_data, n_shard, devices=["cpu"] * n))
    want = _error(lambda: j_make_mesh(n_data, n_shard, devices=jax.devices()[:n]))
    assert got == want
