"""Ungapped extension of the torch port against the JAX package.

``direction_plain`` (the plain version of kernel K2) is held against the
Pallas kernel's ``_direction`` in interpret mode, the XLA ``_direction``
and the oracle's ``_directional_gain``; the fragment wrapper against
``extend_ungapped_pallas``; the gated extension against the JAX
``chain/diagonal.extend_gated`` and the oracle's. All outputs are
integers: the tolerance is exact equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.chain.diagonal import extend_gated as j_extend_gated
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.extend import ungapped as jungapped
from repkiller_tpu.extend import ungapped_pallas as up
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu_torch.chain.diagonal import extend_gated as t_extend_gated
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.convert import to_numpy, to_torch
from repkiller_tpu_torch.extend import extend_dispatch
from repkiller_tpu_torch.extend.ungapped import direction_plain
from repkiller_tpu_torch.extend.ungapped_kernel import _direction, extend_ungapped
from test_torch_cuda import ungapped_boundary_case
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _ref(cfg: Config) -> JConfig:
    """The JAX package's Config with the same fields, for its calls."""
    return JConfig(**dataclasses.asdict(cfg))


K = 8


def _seed_set(seed, n=200, L=1500):
    """A mutated copy with N blocks on both sides; half the seeds on the
    identity diagonal; seeds at both sequence ends; invalid slots in front
    and every slot from n_live on (live seeds dense at the front)."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.06
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    cx[700:705] = 4
    cy[1100:1103] = 4
    px = rng.integers(0, L - K, n).astype(np.int32)
    py = rng.integers(0, L - K, n).astype(np.int32)
    py[:n // 2] = px[:n // 2]
    px[:4] = py[:4] = [0, 1, L - K, L - K - 2]
    n_live = n - 13
    valid = np.ones(n, bool)
    valid[[5, 40, 41]] = False
    valid[n_live:] = False
    return px, py, valid, n_live, cx, cy


def _oracle_direction(px, py, valid, cx, cy, base_off, step, cfg):
    """oracle.pipeline._directional_gain over the valid seeds; zeros
    elsewhere."""
    E = cfg.max_extend
    g = np.arange(E)[None, :]
    gx = px[:, None] + base_off + step * g
    gy = py[:, None] + base_off + step * g
    ok = (gx >= 0) & (gx < cx.shape[0]) & (gy >= 0) & (gy < cy.shape[0])
    xa = cx[np.clip(gx, 0, cx.shape[0] - 1)]
    ya = cy[np.clip(gy, 0, cy.shape[0] - 1)]
    eq = ok & (xa == ya) & (xa < 4)
    out = orc._directional_gain(eq, ok, _ref(cfg))
    return [np.where(valid, o, 0) for o in out]


@pytest.mark.parametrize("max_extend,x_drop", [(64, 30), (128, 40), (256, 12)])
@pytest.mark.parametrize("base_off,step", [(K, +1), (-1, -1)])
def test_direction_plain_matches_pallas_xla_oracle(max_extend, x_drop,
                                                   base_off, step):
    px, py, valid, n_live, cx, cy = _seed_set(max_extend + x_drop)
    cfg = Config(k=K, max_extend=max_extend, x_drop=x_drop)
    sc = (cfg.match, cfg.mismatch, x_drop)
    t = to_torch((px, py, valid, cx, cy), "cpu")
    got = [to_numpy(g) for g in direction_plain(
        *t, base_off, step, *sc, max_extend, torch.tensor(n_live))]
    j = [jnp.asarray(a) for a in (px, py, valid, cx, cy)]
    pallas = up._direction(*j, base_off, step, *sc, max_extend,
                           seed_chunk=256, interpret=True,
                           n_live=jnp.int32(n_live), packed_x=None,
                           packed_y=None)
    wants = [("pallas", pallas),
             ("oracle", _oracle_direction(px, py, valid, cx, cy, base_off,
                                          step, cfg))]
    if max_extend % jungapped.CHUNK == 0:
        wants.append(("xla", jungapped._direction(*j, base_off, step, *sc,
                                                  max_extend)))
    for who, want in wants:
        for name, g, w in zip(("ext", "gain", "idents"), got, want):
            assert g.dtype == np.int32
            assert np.array_equal(g, np.asarray(w)), (who, name)
    ext = got[0]
    assert (ext > 0).any() and (ext == 0).any()


@pytest.mark.parametrize("match,mismatch,x_drop", [
    (4, -4, 20), (1000, -3000, 15000), (4, -4, 2**31 - 1),
    (1000, -3000, 2**31 - 1)])
@pytest.mark.parametrize("base_off,step", [(K, +1), (-1, -1)])
def test_direction_plain_chunk_boundaries(match, mismatch, x_drop, base_off,
                                          step):
    """The chunk contract the CUDA kernel's hand-off at step 32 relies on:
    stops at steps 31, 32, 33, 63 and 64 (by x-drop, five mismatches, and
    by leaving the sequence), a best tied across a chunk boundary, seeds
    that run to E; extreme scores and the drop switched off. Held exactly
    against the Pallas interpreter, the XLA ``_direction`` and the
    oracle."""
    E = 128
    px, py, valid, cx, cy, n_live = ungapped_boundary_case(
        step, K, match, mismatch, 5, E)
    cfg = Config(k=K, max_extend=E, match=match, mismatch=mismatch,
                 x_drop=x_drop)
    sc = (match, mismatch, x_drop)
    got = [to_numpy(g) for g in direction_plain(
        *to_torch((px, py, valid, cx, cy), "cpu"), base_off, step, *sc, E,
        torch.tensor(n_live))]
    j = [jnp.asarray(a) for a in (px, py, valid, cx, cy)]
    wants = [
        ("pallas", up._direction(*j, base_off, step, *sc, E, seed_chunk=256,
                                 interpret=True, n_live=jnp.int32(n_live),
                                 packed_x=None, packed_y=None)),
        ("xla", jungapped._direction(*j, base_off, step, *sc, E)),
        ("oracle", _oracle_direction(px, py, valid, cx, cy, base_off, step,
                                     cfg))]
    for who, want in wants:
        for name, g, w in zip(("ext", "gain", "idents"), got, want):
            assert np.array_equal(g, np.asarray(w)), (who, name)
    ext = got[0]
    # the seeds that leave the sequence at steps 31..64 stop there; the
    # tied bests keep the earlier step; two seeds run to E
    assert list(ext[9:14]) == [31, 32, 33, 63, 64]
    assert list(ext[5:7]) == [31, 32] and ext[7] == E
    if x_drop < 2**31 - 1:
        assert list(ext[:5]) == [27, 28, 29, 59, 60]


def test_max_extend_must_be_a_multiple_of_32():
    px, py, valid, n_live, cx, cy = _seed_set(1, n=64, L=600)
    t = to_torch((px, py, valid, cx, cy), "cpu")
    for bad in (48, 100, -32):
        with pytest.raises(ValueError, match="multiple of 32"):
            direction_plain(*t, K, +1, 4, -4, 30, bad, n_live)
        with pytest.raises(ValueError, match="multiple of 32"):
            _direction(*t, K, +1, 4, -4, 30, bad, n_live=n_live)
    a = _direction(*t, K, +1, 4, -4, 30, 96, n_live=n_live)
    b = direction_plain(*t, K, +1, 4, -4, 30, 96, n_live)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("max_extend", [64, 256])
def test_extend_ungapped_matches_pallas(max_extend):
    px, py, valid, n_live, cx, cy = _seed_set(7 + max_extend)
    cfg = Config(k=K, max_extend=max_extend)
    kw = dict(k=K, match=cfg.match, mismatch=cfg.mismatch, x_drop=cfg.x_drop,
              max_extend=max_extend)
    want = up.extend_ungapped_pallas(
        *[jnp.asarray(a) for a in (px, py, valid, cx, cy)], seed_chunk=256,
        interpret=True, n_live=jnp.int32(n_live), **kw)
    got = extend_ungapped(*to_torch((px, py, valid, cx, cy), "cpu"),
                          n_live=n_live, **kw)
    for f in want:
        assert np.array_equal(to_numpy(got[f]), np.asarray(want[f])), f
    assert (to_numpy(got["length"]) > 2 * K).any()


def _pair_seeds(cfg, seed=5, L=5000, cap=512):
    """Thinned, (diag, px)-sorted pairwise seeds of a near-identical pair
    (1% SNPs, one 12-base N block), padded to ``cap`` slots."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    snp = rng.random(L) < 0.01
    cy[snp] = (cy[snp] + rng.integers(1, 4, snp.sum())) % 4
    cy[3000:3012] = 4
    ix, iy = orc.build_index(cx, cfg.k), orc.build_index(cy, cfg.k)
    px, py = orc.filter_hits(*orc.find_hits(ix, iy, _ref(cfg)), _ref(cfg))
    n = px.shape[0]
    assert 0 < n < cap
    pad = lambda a: np.concatenate([a, np.zeros(cap - n, a.dtype)])  # noqa: E731
    return pad(px), pad(py), np.arange(cap) < n, n, cx, cy


@pytest.mark.parametrize("gate_stride", [0, 2048])
def test_extend_gated_ungapped_matches_jax_and_oracle(gate_stride):
    """max_extend 256 keeps anchors' fragments short of their 2048-bp
    bucket, so some non-anchors are covered and some survive."""
    cfg = Config(k=12, min_hit_dist=16, gate_stride=gate_stride,
                 max_extend=256)
    px, py, valid, n, cx, cy = _pair_seeds(cfg)
    want, wv = j_extend_gated(*[jnp.asarray(a) for a in (px, py, valid, cx, cy)],
                              _ref(cfg), n_live=jnp.int32(n))
    t = to_torch((px, py, valid, cx, cy), "cpu")
    got, gv = t_extend_gated(*t, cfg, n_live=torch.tensor(n))
    assert np.array_equal(to_numpy(gv), np.asarray(wv))
    for f in want:
        assert np.array_equal(to_numpy(got[f]), np.asarray(want[f])), f

    # the oracle lists anchors' fragments, then survivors': compare as rows
    ofrag = orc.extend_gated(px[:n], py[:n], cx, cy, _ref(cfg))
    rows = lambda fr, m: sorted(zip(*[np.asarray(fr[f])[m]  # noqa: E731
                                      for f in orc.FRAG_FIELDS]))
    gvn = to_numpy(gv)
    assert rows(to_numpy(got), gvn) == rows(ofrag, slice(None))
    if gate_stride:
        anchors = orc.gate_anchors(px[:n], py[:n], _ref(cfg))
        kept = gvn[:n]
        assert (~kept).any(), "no seed was covered"
        assert (kept & ~anchors).any(), "no non-anchor survived"
    else:
        assert np.array_equal(gvn, valid)


def test_extend_dispatch_picks_by_mode():
    px, py, valid, n_live, cx, cy = _seed_set(3, n=64, L=600)
    t = to_torch((px, py, valid, cx, cy), "cpu")
    cfg = Config(k=K, max_extend=64)
    got = extend_dispatch(*t, cfg, n_live=n_live)
    want = extend_ungapped(*t, k=K, match=4, mismatch=-4, x_drop=cfg.x_drop,
                           max_extend=64, n_live=n_live)
    assert all(torch.equal(got[f], want[f]) for f in want)
    banded = extend_dispatch(*t, cfg.replace(extend_mode="banded", band=4),
                             n_live=n_live)
    assert any(not torch.equal(banded[f], want[f]) for f in want)
