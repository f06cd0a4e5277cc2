"""The streamed window driver of the torch port against the JAX package:
``join_hits`` with ``self_mode``, ``occ_idx`` and ``same_index`` (hit order
included), ``dist.windows.compare_streamed`` against the JAX package's
and the numpy oracle at several windows, self and pairwise, in both
extend modes; manifest resume, a fingerprint change and resume across the
two packages' checkpoint directories; the per-window overflow messages;
golden30k streamed byte for byte. Integer outputs: exact equality."""

import dataclasses
import io
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.dist import windows as jwindows
from repkiller_tpu.index import build as jbuild
from repkiller_tpu.io import codec
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.seeds import join as jjoin
from repkiller_tpu.utils import synth
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.convert import to_numpy
from repkiller_tpu_torch.dist import windows as twindows
from repkiller_tpu_torch.index import build as tbuild
from repkiller_tpu_torch.io import fasta as tfasta
from repkiller_tpu_torch.report import csv_writer
from repkiller_tpu_torch.seeds import join as tjoin
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
# gate_stride=256 keeps the window quantum lcm(min_hit_dist, gate_stride)
# at 256, so the small windows below survive rounding; the capacities
# hold per window
CFG = Config(k=12, strands="fr", hit_capacity=1 << 11, max_extend=256,
             gate_stride=256)


def _ref(cfg: Config) -> JConfig:
    """The JAX package's Config with the same fields, for its calls."""
    return JConfig(**dataclasses.asdict(cfg))


def _assert_frag_equal(got, want):
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), (f, got[f][:10], want[f][:10])


def _genome(seed=11, L=3000):
    return synth.plant(L, [(120, 3, 0.05, 1), (80, 2, 0.0, 0)], seed=seed).codes


def _streamed(codes_x, codes_y, cfg, stats=None, **kw):
    """The port's and the JAX package's compare_streamed on the same
    inputs, and the oracle's output."""
    got = twindows.compare_streamed(codes_x, codes_y, cfg, device="cpu",
                                    stats=stats, **kw)
    ref = jwindows.compare_streamed(codes_x, codes_y, _ref(cfg), **kw)
    return got, ref, orc.compare(codes_x, codes_y, _ref(cfg))


def _indices(codes_x, codes_y, k, w0=None, win=None):
    """(JAX index, port index) of X, or of X's window [w0, w0 + win) as
    the streamed driver builds it, and of Y."""
    if w0 is not None:
        pad = np.full(max(codes_x.shape[0], w0 + win) + k - 1, 4, np.uint8)
        pad[:codes_x.shape[0]] = codes_x
        codes_x = pad[w0:w0 + win + k - 1]
    jx = list(jbuild.build_index(jnp.asarray(codes_x), k))
    tx = list(tbuild.build_index(torch.from_numpy(codes_x.copy()), k))
    if w0:
        jx[1], tx[1] = jx[1] + w0, tx[1] + w0
    jy = jbuild.build_index(jnp.asarray(codes_y), k)
    ty = tbuild.build_index(torch.from_numpy(codes_y.copy()), k)
    return (jx, jy), (tx, ty)


JOIN_CASES = {
    # a window of X against the whole of X, X's occurrences from its index
    "f window": dict(self_mode="f", window=(1024, 1024), occ=True),
    # a window of X against revcomp(X); its padded tail's anchors are < 0
    "r window": dict(self_mode="r", window=(1024, 2048), rev=True, occ=True),
    # valid X entries with anchors below 0: Y is revcomp of X's first 2000
    "r short y": dict(self_mode="r", rev=True, y_len=2000),
    "f whole": dict(self_mode="f"),
    "f same index": dict(self_mode="f", same_index=True),
    "same index": dict(same_index=True),
    "pair occ": dict(occ=True, window=(512, 1536)),
}


@pytest.mark.parametrize("max_occ", [3, 64])
@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_join_hits_self_modes(case, max_occ):
    """Hits of the port's join equal the JAX package's in order; max_occ 3
    makes the hyper-repeat cap bite on both sides."""
    kw = dict(JOIN_CASES[case])
    k, cap = 12, 1 << 12
    codes = synth.plant(3000, [(200, 4, 0.02, 2), (100, 3, 0.0, 1)],
                        seed=5).codes     # two copies of four inverted
    y = codes[:kw.pop("y_len", codes.shape[0])]
    y = codec.revcomp_codes(y) if kw.pop("rev", False) else y
    w0, win = kw.pop("window", (None, None))
    (jx, jy), (tx, ty) = _indices(codes, y, k, w0, win)
    if kw.pop("occ", False):
        full_j = jbuild.build_index(jnp.asarray(codes), k)
        full_t = tbuild.build_index(torch.from_numpy(codes.copy()), k)
        kw_j = dict(kw, occ_idx=(full_j[0], full_j[2]))
        kw_t = dict(kw, occ_idx=(full_t[0], full_t[2]))
    else:
        kw_j = kw_t = kw
    if kw.get("same_index"):
        jy, ty = jx, tx
    common = dict(k=k, max_occ=max_occ, capacity=cap, y_len=y.shape[0])
    want = jjoin.join_hits(*jx, *jy, **common, **kw_j)
    got = tjoin.join_hits(*tx, *ty, **common, **kw_t)
    for name, g, w in zip(("hpx", "hpy", "hvalid", "total"), got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w)), name
    assert 0 < int(got[3]) <= cap
    if case == "r short y":
        px = to_numpy(tx[1])[:int(tx[2])]
        neg = y.shape[0] - px - k < 0
        assert neg.any() and not np.isin(to_numpy(got[0])[:int(got[3])],
                                         px[neg]).any()


@pytest.mark.parametrize("window", [512, 1024, 4096])
def test_streamed_self_over_window(window):
    stats = {}
    got, ref, want = _streamed(_genome(), None, CFG, window=window,
                               stats=stats)
    _assert_frag_equal(got, ref)
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0 and (got["strand"] == 1).any()
    assert stats["windows"] == -(-(3000 - 11) // window)


def test_streamed_cross_rounds_the_window():
    rng = np.random.default_rng(5)
    cx = rng.integers(0, 4, 2500, dtype=np.uint8)
    cy = rng.integers(0, 4, 1700, dtype=np.uint8)
    cy[200:400] = cx[600:800]
    cy[900:1100] = codec.revcomp_codes(cx[1500:1700])
    stats = {}
    got, ref, want = _streamed(cx, cy, CFG, window=777, stats=stats)
    _assert_frag_equal(got, ref)
    _assert_frag_equal(got, want)
    assert stats["windows"] == 4 and set(got["strand"]) == {0, 1}
    assert twindows._fingerprint(cx, cy, CFG, 768) == \
        jwindows._fingerprint(cx, cy, _ref(CFG), 768)


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
def test_streamed_extend_modes(mode):
    cfg = CFG.replace(extend_mode=mode, band=8)
    codes = synth.plant(3500, [(300, 3, 0.04, 1), (150, 3, 0.0, 0)],
                        seed=17).codes
    got, ref, want = _streamed(codes, None, cfg, window=1024)
    _assert_frag_equal(got, ref)
    _assert_frag_equal(got, want)
    assert got["xStart"].shape[0] > 0


def _drop_last(manifest, n):
    lines = open(manifest).read().splitlines()
    with open(manifest, "w") as f:
        f.write("\n".join(lines[:-n]) + "\n")
    return len(lines)


def _n_lines(manifest):
    with open(manifest) as f:
        return sum(1 for _ in f)


def test_manifest_resume_and_fingerprint(tmp_path):
    codes = _genome(7, L=4000)
    want = orc.compare(codes, None, _ref(CFG))
    out_dir = str(tmp_path / "ckpt")
    got1 = twindows.compare_streamed(codes, None, CFG, out_dir=out_dir,
                                     window=1024, device="cpu")
    _assert_frag_equal(got1, want)
    manifest = os.path.join(out_dir, "manifest.jsonl")
    n = _drop_last(manifest, 2)
    assert n == 8                            # 4 windows x 2 strands
    # the last two windows are computed again, the rest reloaded
    stats = {}
    got2 = twindows.compare_streamed(codes, None, CFG, out_dir=out_dir,
                                     window=1024, device="cpu", stats=stats)
    _assert_frag_equal(got2, want)
    assert _n_lines(manifest) == n
    assert stats["hit_totals"][0] == 0 and stats["hit_totals"][1] > 0
    # another Config: another fingerprint, nothing reused, still right
    cfg2 = CFG.replace(min_len=41)
    got3 = twindows.compare_streamed(codes, None, cfg2, out_dir=out_dir,
                                     window=1024, device="cpu")
    _assert_frag_equal(got3, orc.compare(codes, None, _ref(cfg2)))
    assert _n_lines(manifest) == 2 * n
    # resume=False computes every window again
    stats = {}
    twindows.compare_streamed(codes, None, CFG, out_dir=out_dir, window=1024,
                              resume=False, device="cpu", stats=stats)
    assert min(stats["seed_counts"]) > 0 and _n_lines(manifest) == 3 * n


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, writer):
    """One package writes every window, the other redoes the two dropped
    from the manifest, then the writer resumes the mixed directory and
    computes nothing; every output equals the oracle's, and both packages
    write the same arrays under the same names."""
    codes = _genome(8, L=4000)
    want = orc.compare(codes, None, _ref(CFG))
    out_dir = str(tmp_path / "ckpt")
    manifest = os.path.join(out_dir, "manifest.jsonl")

    def port():
        return twindows.compare_streamed(codes, None, CFG, out_dir=out_dir,
                                         window=1024, device="cpu")

    def jax():
        return jwindows.compare_streamed(codes, None, _ref(CFG),
                                         out_dir=out_dir, window=1024)

    first, second = (jax, port) if writer == "jax" else (port, jax)
    _assert_frag_equal(first(), want)
    recs = [json.loads(line) for line in open(manifest)]
    n = _drop_last(manifest, 2)
    kept = {r["file"]: dict(np.load(os.path.join(out_dir, r["file"])))
            for r in recs[-2:]}
    _assert_frag_equal(second(), want)
    assert open(manifest).read().splitlines()[-2:] == \
        [json.dumps(r) for r in recs[-2:]]
    for name, arrays in kept.items():
        with np.load(os.path.join(out_dir, name)) as z:
            assert sorted(z.files) == sorted(arrays)
            for f in z.files:
                assert z[f].dtype == arrays[f].dtype, f
                assert np.array_equal(z[f], arrays[f]), f
    _assert_frag_equal(first(), want)
    assert _n_lines(manifest) == n


@pytest.mark.parametrize("what,cfg", [
    ("hit_capacity", CFG.replace(hit_capacity=16)),
    ("seed_capacity", CFG.replace(seed_capacity=2)),
])
def test_window_overflow_raises(what, cfg):
    """The same per-window message as the JAX package's."""
    codes = _genome(9)
    with pytest.raises(ValueError, match=what) as want:
        jwindows.compare_streamed(codes, None, _ref(cfg), window=1024)
    with pytest.raises(ValueError, match=what) as got:
        twindows.compare_streamed(codes, None, cfg, window=1024, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("window ")


def test_golden_streamed(tmp_path):
    cfg = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=512,
                 extend_mode="banded", band=8)
    ss = tfasta.read_fasta(str(GOLDEN / "golden30k.fasta"))
    frag = twindows.compare_streamed(ss.codes, None, cfg, out_dir=str(tmp_path),
                                     window=8192, device="cpu")
    buf = io.StringIO()
    csv_writer.write_frags_csv(frag, buf, x_name=ss.names[0],
                               x_len=ss.total_length)
    assert buf.getvalue() == (GOLDEN / "golden30k.frags.csv").read_text()


def test_streamed_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        twindows.compare_streamed(_genome(), None, CFG, window=1024)
