"""k-mer index and seed stages of the torch port against the JAX package on
synthetic genomes (synth.plant, 5-30 kb, with N blocks): every CanonIndex
field, both strands' hit arrays and true totals, and the thinned seeds.
Integer outputs: exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.index import build as jbuild
from repkiller_tpu.index import canonical as jcanon
from repkiller_tpu.seeds.filter import filter_hits as j_filter
from repkiller_tpu.seeds.self_join import join_self_canonical as j_join
from repkiller_tpu.utils import synth
from repkiller_tpu_torch.convert import to_numpy, to_torch
from repkiller_tpu_torch.index import build as tbuild
from repkiller_tpu_torch.index import canonical as tcanon
from repkiller_tpu_torch.seeds.filter import filter_hits as t_filter
from repkiller_tpu_torch.seeds.self_join import join_self_canonical as t_join
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CASES = [(5000, 12, 11), (12000, 11, 12), (30000, 16, 13)]   # (L, k, seed)


def _genome(L, seed):
    g = synth.plant(L, [(300, 4, 0.03, 1), (150, 3, 0.0, 1), (60, 5, 0.05, 0)],
                    seed=seed)
    codes = g.codes.copy()
    codes[L // 3:L // 3 + 20] = 4
    return codes


@functools.partial(jax.jit, static_argnames=("k",))
def _j_index(codes, k):
    return jcanon.build_canonical_index(codes, k)


def _assert_same(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    assert np.array_equal(got, want), (what, got[:10], want[:10])


@pytest.mark.parametrize("k", [1, 7, 12, 16])
def test_extract_and_revcomp_kmers(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, 700).astype(np.uint8)
    km, pos, valid = tbuild.extract_kmers(torch.from_numpy(codes), k)
    wkm, wpos, wvalid = jbuild.extract_kmers(jnp.asarray(codes), k)
    _assert_same(km, wkm, "kmer")
    _assert_same(pos, wpos, "pos")
    _assert_same(valid, wvalid, "valid")
    _assert_same(tcanon.revcomp_kmer(km, k), jcanon.revcomp_kmer(wkm, k), "rc")


@pytest.mark.parametrize("L,k,seed", CASES)
def test_canonical_index_fields(L, k, seed):
    codes = _genome(L, seed)
    want = _j_index(jnp.asarray(codes), k)
    got = tcanon.build_canonical_index(torch.from_numpy(codes), k)
    for f in want._fields:
        _assert_same(getattr(got, f), getattr(want, f), f)
    assert got.pos.dtype == torch.int32 and got.palin.dtype == torch.bool


@pytest.mark.parametrize("L,k,seed", CASES)
def test_self_join_and_filter(L, k, seed):
    """Hit arrays (order included) and totals from the port's own index and
    from the JAX index carried over with convert.to_torch; then the
    thinning of both strands, with and without an out_capacity trim."""
    codes = _genome(L, seed)
    cap, max_occ = 1 << 14, 32
    jci = _j_index(jnp.asarray(codes), k)
    want = j_join(jci, k, max_occ, cap, L)
    tci = tcanon.build_canonical_index(torch.from_numpy(codes), k)
    carried = tcanon.CanonIndex(**to_torch(
        {f: np.asarray(v) for f, v in jci._asdict().items()}, "cpu"))
    for ci in (tci, carried):
        got = t_join(ci, k, max_occ, cap, L)
        for strand in (0, 1):
            for name, g, w in zip(("px", "py", "valid", "total"),
                                  got[strand], want[strand]):
                _assert_same(g, w, (strand, name))
    assert int(want[0][3]) > 0 and int(want[1][3]) > 0
    for strand in (0, 1):
        hits = got[strand][:3]
        for out_cap in (None, 32):
            w = j_filter(*want[strand][:3], 32, out_capacity=out_cap)
            g = t_filter(*hits, 32, out_capacity=out_cap)
            for name, a, b in zip(("px", "py", "valid", "n_kept"), g, w):
                _assert_same(a, b, (strand, out_cap, name))
            assert int(g[3]) > 32                    # the trim cuts real seeds
