"""The pairwise path of the torch port against the JAX package: the sorted
k-mer index, the merge-by-sort ranks, the pairwise join (hit order
included), and ``device.compare`` of a strain pair built like
benchmarks/run_config3.py against the JAX device pipeline and the numpy
oracle, in both extend modes and for strands f, r and fr; the overflow
contract; and the default ``Config()`` end to end, self and pairwise.
Integer outputs: exact equality."""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu import device as jdevice
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.index import build as jbuild
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.seeds import join as jjoin
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.convert import to_numpy, to_torch
from repkiller_tpu_torch.index import build as tbuild
from repkiller_tpu_torch.seeds import join as tjoin


def _ref(cfg: Config) -> JConfig:
    """The JAX package's Config with the same fields, for its calls."""
    return JConfig(**dataclasses.asdict(cfg))


ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmarks"))
import run_config3  # noqa: E402  (benchmarks/ is not a package)
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PAIR_SIZE = 20000
CAP = 1 << 16


@functools.lru_cache(maxsize=None)
def _pair():
    return run_config3.make_strain_pair(PAIR_SIZE, seed=77)


def _assert_frag_equal(got, want):
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), (f, got[f][:10], want[f][:10])


def _codes(seed, L=3000):
    """Random codes with N blocks and a poly-T run (its k=16 k-mers equal
    the sentinel 0xFFFFFFFF and stay valid)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, L, dtype=np.uint8)
    codes[100:140] = 3
    codes[700:710] = 4
    codes[1500:1504] = 4
    codes[2000:2600] = codes[200:800]                 # a repeat: many ties
    return codes


@pytest.mark.parametrize("k", [1, 7, 12, 16])
def test_build_index(k):
    codes = _codes(k)
    got = tbuild.build_index(torch.from_numpy(codes), k)
    want = jax.jit(jbuild.build_index, static_argnames="k")(
        jnp.asarray(codes), k=k)
    for name, g, w in zip(("kmer", "pos", "n_valid"), got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w)), name
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_ranks_by_sort():
    """Query positions -1, MAXP, in-range, and negative anchors
    (y_len - px - k, which the reverse self-join asks for); query k-mers
    present, absent and equal to the sentinel."""
    k = 16
    codes = _codes(3)
    ka, pa, nv = jbuild.build_index(jnp.asarray(codes), k)
    ka_np, pa_np = np.asarray(ka), np.asarray(pa)
    rng = np.random.default_rng(4)
    nq = 700
    kq = ka_np[rng.integers(0, ka_np.shape[0], nq)].copy()
    kq[:50] = rng.integers(0, 2**32 - 1, 50, dtype=np.uint64).astype(np.uint32)
    kq[50:60] = 0xFFFFFFFF
    pos = rng.integers(0, codes.shape[0], nq).astype(np.int32)
    pqs = [np.full(nq, -1, np.int32), np.full(nq, tjoin.MAXP, np.int32), pos,
           (500 - pos - k).astype(np.int32)]
    assert (pqs[3] < 0).any()
    want = jjoin.ranks_by_sort(ka, pa, nv, [jnp.asarray(kq)] * 4,
                               [jnp.asarray(p) for p in pqs])
    t = to_torch((ka_np, pa_np, kq), "cpu")
    got = tjoin.ranks_by_sort(t[0], t[1], torch.tensor(int(nv)), [t[2]] * 4,
                              [torch.from_numpy(p) for p in pqs])
    for q, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        assert np.array_equal(to_numpy(g), np.asarray(w)), q
    assert (to_numpy(got[1]) > to_numpy(got[0])).any()


@pytest.mark.parametrize("max_occ", [3, 64])
def test_join_hits(max_occ):
    """The pairwise join on the strain pair; max_occ 3 makes the
    hyper-repeat cap bite. Hits match in order."""
    k = 12
    a, b = _pair()
    jx = jbuild.build_index(jnp.asarray(a), k)
    jy = jbuild.build_index(jnp.asarray(b), k)
    want = jjoin.join_hits(*jx, *jy, k=k, max_occ=max_occ, capacity=CAP,
                           y_len=b.shape[0])
    tx = tbuild.build_index(torch.from_numpy(a), k)
    ty = tbuild.build_index(torch.from_numpy(b), k)
    got = tjoin.join_hits(*tx, *ty, k=k, max_occ=max_occ, capacity=CAP,
                          y_len=b.shape[0])
    for name, g, w in zip(("hpx", "hpy", "hvalid", "total"), got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w)), name
    assert 0 < int(got[3]) <= CAP
    if max_occ == 3:
        full = tjoin.join_hits(*tx, *ty, k=k, max_occ=64, capacity=CAP)
        assert int(got[3]) < int(full[3])            # the cap dropped hits


def test_join_hits_unported_arguments_raise():
    """``shard`` is ported (tests/test_torch_shards.py); a shard count that
    is not a power of two is refused."""
    t = tbuild.build_index(torch.from_numpy(_codes(5)), 12)
    with pytest.raises(ValueError, match="power of two"):
        tjoin.join_hits(*t, *t, k=12, max_occ=8, capacity=64, shard=(0, 3))


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("strands", ["f", "r", "fr"])
def test_compare_pairwise(mode, strands):
    a, b = _pair()
    cfg = Config(k=12, strands=strands, extend_mode=mode, hit_capacity=CAP,
                 max_extend=2048 if mode == "ungapped" else 256)
    got = tdevice.compare(a, b, cfg, "cpu")
    _assert_frag_equal(got, orc.compare(a, b, _ref(cfg)))
    if strands == "fr":
        _assert_frag_equal(got, jdevice.compare(a, b, _ref(cfg)))
    for s in map("fr".index, strands):
        assert (got["strand"] == s).any(), s


@pytest.mark.parametrize("what,cfg", [
    ("hit_capacity", Config(k=12, hit_capacity=1 << 12)),
    ("seed_capacity", Config(k=12, hit_capacity=CAP, seed_capacity=64)),
])
def test_pairwise_capacity_overflow_raises(what, cfg):
    a, b = _pair()
    with pytest.raises(ValueError, match=what):
        tdevice.compare(a, b, cfg, "cpu")


def test_pairwise_fragment_capacity_overflow_raises():
    """One shared unit between N blocks: one seed, one fragment, which
    fills a one-slot fragment array."""
    unit = synth.random_codes(300, seed=8)
    gap = np.full(50, 4, np.uint8)
    x = np.concatenate([gap, unit, gap])
    y = np.concatenate([unit, gap])
    cfg = Config(k=12, min_hit_dist=4096, hit_capacity=512, seed_capacity=1)
    with pytest.raises(ValueError, match="frag capacity"):
        tdevice.compare(x, y, cfg, "cpu")
    ok = tdevice.compare(x, y, cfg.replace(seed_capacity=2), "cpu")
    assert ok["xStart"].shape[0] == 1
    _assert_frag_equal(ok, orc.compare(x, y, _ref(cfg)))


def test_default_config_end_to_end():
    """Config() as the tool runs it (ungapped, strand f, capacities 2^20),
    self and pairwise, against the JAX device pipeline, group included."""
    cfg = Config()
    g = synth.plant(6000, [(400, 3, 0.03, 0), (150, 4, 0.0, 0)], seed=9)
    y = g.codes[1000:5000].copy()
    y[::50] = (y[::50] + 1) % 4
    for codes_y in (None, y):
        got = tdevice.compare(g.codes, codes_y, cfg, "cpu")
        _assert_frag_equal(got, jdevice.compare(g.codes, codes_y, _ref(cfg)))
        assert got["xStart"].shape[0] > 0


def test_strain_pair_copy_matches_benchmark():
    """chip_smoke.py carries its own copy of run_config3's generator (the
    card's machine has no JAX for benchmarks/common.py)."""
    for size, seed in ((PAIR_SIZE, 77), (6000, 3)):
        want = run_config3.make_strain_pair(size, seed)
        got = chip_smoke.make_strain_pair(size, seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
