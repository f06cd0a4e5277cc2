"""Banded extension of the torch port against the JAX package.

``direction_plain`` (the plain version of kernel K1) is held against the
Pallas kernel's ``_direction`` in interpret mode, the two-phase gated and
ungated wrappers against their JAX counterparts and the numpy oracle. All
outputs are integers: the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.config import Config
from repkiller_tpu.extend import banded_pallas as bp
from repkiller_tpu.oracle import banded as obanded
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth
from repkiller_tpu_torch.convert import to_numpy, to_torch
from repkiller_tpu_torch.extend import _cuda
from repkiller_tpu_torch.extend.banded import direction_plain
from repkiller_tpu_torch.extend.banded_kernel import (
    _direction, extend_banded, extend_banded_gated)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SCORES = dict(match=4, mismatch=-4, gap_open=8, gap_extend=2)


def _seed_set(seed, n=128, L=900, k=8):
    """Near-identical sequences with indels and an N block; seeds near the
    sequence ends; invalid slots in front and every slot from n_live on
    invalid (live seeds are dense at the front)."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.03
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    cy[L // 2:] = np.roll(cy[L // 2:], 2)            # a 2-base shift
    cx[300:306] = 4                                  # an N block in x
    px = rng.integers(0, L - k, n).astype(np.int32)
    py = np.clip(px + rng.integers(-3, 4, n), 0, L - k).astype(np.int32)
    px[:4] = [0, 1, L - k, L - k - 3]                # both sequence ends
    py[:4] = px[:4]
    px[4:8] = [290, 296, 302, 310]                   # around the Ns
    py[4:8] = px[4:8]
    n_live = n - 9
    valid = np.ones(n, bool)
    valid[[8, 20]] = False
    valid[n_live:] = False
    return px, py, valid, n_live, cx, cy


@pytest.mark.parametrize("band", [4, 8, 16])
@pytest.mark.parametrize("shape", ["phase1", "full"])
def test_direction_plain_matches_pallas(band, shape):
    k, x_drop = 8, 30
    px, py, valid, n_live, cx, cy = _seed_set(band)
    if shape == "phase1":       # row cap E1, jcap = E1 + band, right extension
        E, jcap, base_off, step = 32, 32 + band, k, +1
    else:                       # full pass, jcap = E, left extension
        E, jcap, base_off, step = 64, 64, -1, -1
    sc = (SCORES["match"], SCORES["mismatch"], x_drop)
    want = bp._direction(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), jnp.asarray(cx),
        jnp.asarray(cy), base_off, step, *sc, E, band, SCORES["gap_open"],
        SCORES["gap_extend"], seed_chunk=128, interpret=True,
        n_live=jnp.int32(n_live), jcap_override=jcap)
    t = to_torch((px, py, valid, cx, cy), "cpu")
    got = direction_plain(*t, base_off, step, *sc, E, band, SCORES["gap_open"],
                          SCORES["gap_extend"], jcap, torch.tensor(n_live))
    for name, g, w in zip(("ei", "ej", "gain", "idents", "alive"), got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # the cases reach gapped endpoints, the row cap and dead seeds
    alive = got[4].numpy()
    assert alive.any() and (alive[:n_live][valid[:n_live]] == 0).any()
    assert (got[0].numpy() != got[1].numpy()).any()


def test_dispatch_cpu_is_plain_and_kernel_checks_inputs():
    px, py, valid, n_live, cx, cy = _seed_set(3, n=32, L=300)
    t = to_torch((px, py, valid, cx, cy), "cpu")
    args = (4, -4, 30, 40, 4, 8, 2)
    a = _direction(*t, 8, +1, *args, n_live=n_live)
    b = direction_plain(*t, 8, +1, *args, 40, n_live)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="band"):
        _cuda.banded_gotoh(*t, 8, +1, 4, -4, 30, 40, -1, 8, 2, 40, n_live)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.banded_gotoh(*t, 8, +1, *args, 40, n_live)


def _gated_inputs(seed, cfg):
    g = synth.plant(2500, [(200, 3, 0.02, 0), (120, 2, 0.05, 0)], seed=seed)
    idx = orc.build_index(g.codes, cfg.k)
    px, py = orc.find_hits(idx, idx, cfg, self_mode="f")
    px, py = orc.filter_hits(px, py, cfg)
    anchor = orc.gate_anchors(px, py, cfg)
    cap = 128
    n = px.shape[0]
    assert 0 < n < cap
    pad = lambda a: np.concatenate([a, np.zeros(cap - n, a.dtype)])  # noqa: E731
    return pad(px), pad(py), np.arange(cap) < n, pad(anchor), n, g.codes


@pytest.mark.parametrize("max_extend", [96, 36])   # two-phase / one pass
def test_extend_banded_gated_matches_pallas(max_extend):
    cfg = Config(k=12, gate_stride=128, min_hit_dist=16, strands="f",
                 extend_mode="banded", band=4, max_extend=max_extend)
    px, py, valid, anchor, n, codes = _gated_inputs(77, cfg)
    kw = dict(k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
              x_drop=cfg.x_drop, max_extend=cfg.max_extend, band=cfg.band,
              gap_open=cfg.gap_open, gap_extend=cfg.gap_extend, phase1_rows=32)
    want, wv = bp.extend_banded_pallas_gated(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid),
        jnp.asarray(anchor), jnp.asarray(codes), jnp.asarray(codes),
        seed_chunk=128, interpret=True, n_live=jnp.int32(n), **kw)
    t = to_torch((px, py, valid, anchor, codes), "cpu")
    got, gv = extend_banded_gated(*t[:4], t[4], t[4], n_live=n, **kw)
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert gv.numpy().sum() < valid.sum()            # gating dropped seeds
    for f in want:
        assert np.array_equal(to_numpy(got[f]), np.asarray(want[f])), f


def test_extend_banded_matches_oracle():
    """Two-phase ungated extension (phase 1 at 32 rows, deep survivors
    re-run to max_extend) against the numpy oracle."""
    cfg = Config(k=8, band=4, max_extend=160, x_drop=40, extend_mode="banded")
    rng = np.random.default_rng(33)
    L = 2000
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.02
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    n = 100
    px = rng.integers(0, L - cfg.k, n).astype(np.int32)
    py = np.clip(px + rng.integers(-2, 3, n), 0, L - cfg.k).astype(np.int32)
    valid = np.arange(n) < 90
    t = to_torch((px, py, valid, cx, cy), "cpu")
    got = extend_banded(*t, k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
                        x_drop=cfg.x_drop, max_extend=cfg.max_extend,
                        band=cfg.band, gap_open=cfg.gap_open,
                        gap_extend=cfg.gap_extend, n_live=90, phase1_rows=32)
    want = obanded.extend_banded(px[:90], py[:90], cx, cy, cfg)
    for f in orc.FRAG_FIELDS:
        g = to_numpy(got[f])
        assert np.array_equal(g[:90], want[f]), f
        assert not g[90:].any(), f
    assert (want["length"] > 32 + cfg.k).any()       # deep survivors exist
