"""The sharded indexes and the sharded seed joins of the torch port against
the JAX package (index/shards.py, ``join_hits(shard=)``,
``join_self_canonical(entry_slice=)``). The JAX builds run on the
8-virtual-device CPU mesh of tests/conftest.py; the port's distributed
builds run on a one-process mesh of CPU bodies, whose row s of body (d, s)
must equal the JAX build's row s for every d. Integer outputs: exact
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.dist.mesh import make_mesh as j_make_mesh
from repkiller_tpu.index import build as jbuild
from repkiller_tpu.index import canonical as jcanon
from repkiller_tpu.index import shards as jshards
from repkiller_tpu.seeds.join import join_hits as j_join_hits
from repkiller_tpu.seeds.self_join import join_self_canonical as j_join_self
from repkiller_tpu.utils import synth
from repkiller_tpu_torch.convert import to_numpy
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.index import build as tbuild
from repkiller_tpu_torch.index import canonical as tcanon
from repkiller_tpu_torch.index import shards as tshards
from repkiller_tpu_torch.seeds.join import join_hits as t_join_hits
from repkiller_tpu_torch.seeds.self_join import join_self_canonical as t_join_self
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

K = 12
SHAPES = [(1, 2), (2, 2), (4, 2), (2, 4)]


def _genome(L=6000, seed=11):
    """Planted repeats and a block of Ns, as the reference's shard tests."""
    g = synth.plant(L, [(150, 3, 0.03, 1), (80, 4, 0.0, 0)], seed=seed)
    codes = np.asarray(g.codes).copy()
    codes[777:790] = 4
    return codes


def _same(got, want, what):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want), (
        what, got[:8], want[:8])


def _j_mesh(shape):
    return j_make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])


def _t_mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _j_dist_kmer(codes, k, shape, cap, slack):
    mesh = _j_mesh(shape)
    fn = jax.jit(lambda c: jshards.build_sharded_index_dist(
        c, k, shape[1], cap, mesh, "data", "shard", slack))
    return [np.asarray(a) for a in fn(jnp.asarray(codes))]


def _j_dist_canon(codes, k, shape, cap, slack):
    mesh = _j_mesh(shape)
    fn = jax.jit(lambda c: jshards.build_canonical_dist(
        c, k, shape[1], cap, mesh, "data", "shard", slack))
    ci, cnt, blk = fn(jnp.asarray(codes))
    return [np.asarray(f) for f in ci], np.asarray(cnt), np.asarray(blk)


def _t_dist(build, codes, k, shape, cap, slack):
    mesh = _t_mesh(shape)
    return build(mesh.replicate(codes), k, cap, mesh, slack), mesh


@pytest.mark.parametrize("n_shard", [1, 2, 4])
def test_build_sharded_index_matches_jax(n_shard):
    codes = _genome(5000, seed=5)
    cap = tshards.shard_capacity(codes.shape[0] - K + 1, n_shard, 1.5)
    assert cap == jshards.shard_capacity(codes.shape[0] - K + 1, n_shard, 1.5)
    got = tshards.build_sharded_index(torch.from_numpy(codes), K, n_shard, cap)
    want = jax.jit(jshards.build_sharded_index, static_argnums=(1, 2, 3))(
        jnp.asarray(codes), K, n_shard, cap)
    for name, g, w in zip(("kS", "pS", "cnt"), got, want):
        _same(g, w, name)


@pytest.mark.parametrize("n_pos,n_shard,slack", [
    (1, 1, 1.5), (100, 1, 1.5), (1000, 3, 1.0), (12345, 8, 2.5), (7, 4, 4.0)])
def test_shard_capacity_matches_jax(n_pos, n_shard, slack):
    assert (tshards.shard_capacity(n_pos, n_shard, slack)
            == jshards.shard_capacity(n_pos, n_shard, slack))


@pytest.mark.parametrize("shape", SHAPES)
def test_build_sharded_index_dist_matches_jax(shape):
    codes = _genome()
    cap = tshards.shard_capacity(codes.shape[0] - K + 1, shape[1], 1.5)
    kW, pW, cW, bW = _j_dist_kmer(codes, K, shape, cap, 1.5)
    got, mesh = _t_dist(tshards.build_sharded_index_dist, codes, K, shape, cap, 1.5)
    assert bW[0] <= bW[1], "shuffle block overflow in the test workload"
    for (d, s), (kS, pS, cnt, blk) in got.items():
        _same(kS, kW[s], f"kS of body {(d, s)}")
        _same(pS, pW[s], f"pS of body {(d, s)}")
        _same(cnt, cW, "cnt")
        _same(blk, bW, "blk_over")
    # the shards are the global-sort build's rows
    want = tshards.build_sharded_index(torch.from_numpy(codes), K, shape[1], cap)
    _same(torch.stack([got[(0, s)][0] for s in range(shape[1])]), to_numpy(want[0]),
          "kS against build_sharded_index")


@pytest.mark.parametrize("shape,k", [(s, K) for s in SHAPES] + [((2, 2), 16)])
def test_build_canonical_dist_matches_jax(shape, k):
    """Every CanonIndex field of every shard; k=16 has canonical values of
    2^31 and above, whose hash passes 2^63 before its mask."""
    codes = _genome()
    cap = tshards.shard_capacity(codes.shape[0] - k + 1, shape[1], 1.5)
    cap = -(-cap // shape[0]) * shape[0]
    ciW, cW, bW = _j_dist_canon(codes, k, shape, cap, 1.5)
    got, mesh = _t_dist(tshards.build_canonical_dist, codes, k, shape, cap, 1.5)
    assert bW[0] <= bW[1]
    if k == 16:
        canon, _, valid = tcanon.canon_posfp(torch.from_numpy(codes), k)
        assert int(canon[valid].max()) >= 1 << 31
    for (d, s), (ci, cnt, blk) in got.items():
        for name, g, w in zip(tcanon.CanonIndex._fields, ci, ciW):
            _same(g, w[s], f"{name} of body {(d, s)}")
        _same(cnt, cW, "cnt")
        _same(blk, bW, "blk_over")


def test_all_T_k16_vs_pad_disambiguation():
    """Valid all-T k=16 k-mers equal SENTINEL; the shuffle's pads must still
    sort after them (pos = MAXP)."""
    k, shape = 16, (2, 2)
    codes = np.full(200, 3, np.uint8)
    n_pos = codes.shape[0] - k + 1
    cap = tshards.shard_capacity(n_pos, 2, 4.0)
    kW, pW, cW, bW = _j_dist_kmer(codes, k, shape, cap, 4.0)
    got, _ = _t_dist(tshards.build_sharded_index_dist, codes, k, shape, cap, 4.0)
    kS, pS, cnt, blk = got[(0, 1)]
    assert int(blk[0]) <= int(blk[1]) and int(cnt.sum()) == n_pos
    assert np.array_equal(np.sort(to_numpy(pS)[: int(cnt[1])]),
                          np.arange(n_pos, dtype=np.int32))
    for (d, s), (kS, pS, cnt, blk) in got.items():
        _same(kS, kW[s], "kS")
        _same(pS, pW[s], "pS")
        _same(cnt, cW, "cnt")


@pytest.mark.parametrize("build", ["kmer", "canonical"])
def test_overflow_counts_match_jax(build):
    """Poly-A and poly-C runs skew every k-mer into few shards: the true
    shard counts pass cap_shard and the largest send block passes cap_blk,
    and both counts are the reference's."""
    codes = _genome(3000, seed=3)
    codes[:1200] = 0
    codes[2000:2600] = 1
    shape, slack = (2, 2), 1.0
    cap = tshards.shard_capacity(codes.shape[0] - K + 1, 2, slack)
    cap = -(-cap // 2) * 2
    if build == "kmer":
        kW, pW, cW, bW = _j_dist_kmer(codes, K, shape, cap, slack)
        got, _ = _t_dist(tshards.build_sharded_index_dist, codes, K, shape, cap, slack)
        cnt, blk = got[(1, 1)][2], got[(1, 1)][3]
    else:
        _, cW, bW = _j_dist_canon(codes, K, shape, cap, slack)
        got, _ = _t_dist(tshards.build_canonical_dist, codes, K, shape, cap, slack)
        cnt, blk = got[(1, 1)][1], got[(1, 1)][2]
    assert cW.max() > cap and bW[0] > bW[1]
    _same(cnt, cW, "cnt")
    _same(blk, bW, "blk_over")


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_join_hits_shard_matches_jax(n_shards):
    """Every shard's hits equal the JAX package's, and the shards' hits
    together are the unsharded join's."""
    codes = _genome(5000, seed=7)
    rng = np.random.default_rng(8)
    y = codes[1000:4000].copy()
    y[rng.random(y.shape[0]) < 0.02] = 1
    tx = tbuild.build_index(torch.from_numpy(codes), K)
    ty = tbuild.build_index(torch.from_numpy(y), K)
    jx = jbuild.build_index(jnp.asarray(codes), K)
    jy = jbuild.build_index(jnp.asarray(y), K)
    cap = 1 << 14
    full = t_join_hits(*tx, *ty, k=K, max_occ=16, capacity=cap)
    union, total = set(), 0
    for s in range(n_shards):
        got = t_join_hits(*tx, *ty, k=K, max_occ=16, capacity=cap,
                          shard=(s, n_shards))
        want = j_join_hits(*jx, *jy, k=K, max_occ=16, capacity=cap,
                           shard=(s, n_shards))
        for name, g, w in zip(("hpx", "hpy", "hvalid", "total"), got, want):
            _same(g, w, f"{name} of shard {s}")
        n = int(got[3])
        total += n
        union |= set(zip(to_numpy(got[0])[:n].tolist(), to_numpy(got[1])[:n].tolist()))
    n = int(full[3])
    assert total == n > 0
    assert union == set(zip(to_numpy(full[0])[:n].tolist(),
                            to_numpy(full[1])[:n].tolist()))


def test_join_hits_shard_modulo_owner():
    """When 2k <= log2(n_shards) the owner is kx % n_shards."""
    codes = np.random.default_rng(4).integers(0, 4, 600).astype(np.uint8)
    k = 1
    tx = tbuild.build_index(torch.from_numpy(codes), k)
    jx = jbuild.build_index(jnp.asarray(codes), k)
    for s in range(4):
        got = t_join_hits(*tx, *tx, k=k, max_occ=1000, capacity=1 << 18,
                          shard=(s, 4))
        want = j_join_hits(*jx, *jx, k=k, max_occ=1000, capacity=1 << 18,
                           shard=(s, 4))
        for name, g, w in zip(("hpx", "hpy", "hvalid", "total"), got, want):
            _same(g, w, f"{name} of shard {s}")


def _slices(n, n_slices):
    blk = -(-n // n_slices)
    return [(off, min(blk, n - off)) for off in range(0, n, blk)]


@pytest.mark.parametrize("slices", [
    lambda n: _slices(n, 1), lambda n: _slices(n, 3), lambda n: _slices(n, 8),
    lambda n: [(n - 100, 100)], lambda n: [(n - 50, 100)], lambda n: [(0, 1)]],
    ids=["one", "three", "eight", "tail", "past-the-end", "first"])
def test_join_self_canonical_entry_slice_matches_jax(slices):
    """Each slice's hits equal the JAX package's, both strands; slices that
    tile the entries give together the unsliced join's hits. A slice that
    runs past the entries has its start clamped, as dynamic_slice does."""
    codes = _genome(4000, seed=9)
    tci = tcanon.build_canonical_index(torch.from_numpy(codes), K)
    jci = jax.jit(jcanon.build_canonical_index, static_argnums=1)(
        jnp.asarray(codes), K)
    n, cap, y_len = tci.pos.shape[0], 1 << 13, codes.shape[0]
    full = t_join_self(tci, K, 32, cap, y_len)
    union = [set(), set()]
    for off, m in slices(n):
        got = t_join_self(tci, K, 32, cap, y_len, entry_slice=(off, m))
        want = j_join_self(jci, K, 32, cap, y_len,
                           entry_slice=(jnp.int32(off), m))
        for strand in (0, 1):
            for name, g, w in zip(("hpx", "hpy", "valid", "total"),
                                  got[strand], want[strand]):
                _same(g, w, f"{name} of slice {(off, m)} strand {strand}")
            c = int(got[strand][3])
            union[strand] |= set(zip(to_numpy(got[strand][0])[:c].tolist(),
                                     to_numpy(got[strand][1])[:c].tolist()))
    if sum(m for _, m in slices(n)) == n:
        for strand in (0, 1):
            c = int(full[strand][3])
            assert c > 0 and union[strand] == set(zip(
                to_numpy(full[strand][0])[:c].tolist(),
                to_numpy(full[strand][1])[:c].tolist()))
