"""Staged execution with resume (``device.compare_staged``,
``keep_intermediates``) and per-stage timing (``utils/metrics``) of the
torch port against the JAX package: the staged output, self and pairwise,
equals ``repkiller_tpu.device.compare``'s; a resume reloads every heavy
stage; a Config change changes the fingerprint; the fingerprint is the
JAX package's, so either package resumes from the other's stage files;
``profile_stages`` gives the JAX package's records but for ``wall_s``.
Integer outputs: exact equality."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from repkiller_tpu import device as jdevice
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import checkpoint as jcheckpoint
from repkiller_tpu.utils import metrics as jmetrics
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.utils import checkpoint as tcheckpoint
from repkiller_tpu_torch.utils import metrics as tmetrics
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = Config(k=12, strands="fr", hit_capacity=1 << 12, max_extend=256,
             extend_mode="banded", band=8)
HEAVY = ("seeds", "extend", "join", "index_x", "index_y", "filter")


def _ref(cfg: Config) -> JConfig:
    """The JAX package's Config with the same fields, for its calls."""
    return JConfig(**dataclasses.asdict(cfg))


def _assert_frag_equal(got, want):
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), (f, got[f][:10], want[f][:10])


def _inputs(self_cmp):
    g = synth.plant(4000, [(150, 3, 0.02, 1), (300, 3, 0.04, 1)], seed=50)
    if self_cmp:
        return g.codes, None
    rng = np.random.default_rng(51)
    return g.codes, synth.mutate(g.codes, 0.05, rng)[:3500]


def _stage_files(d):
    return sorted(os.path.basename(p) for p in glob.glob(d + "/stage_*.npz"))


@pytest.mark.parametrize("self_cmp", [True, False], ids=["self", "pair"])
def test_staged_matches_jax_and_fused(tmp_path, self_cmp):
    cx, cy = _inputs(self_cmp)
    timings = {}
    got = tdevice.compare(cx, cy, CFG, "cpu", timings=timings,
                          keep_intermediates=str(tmp_path / "ckpt"))
    _assert_frag_equal(got, jdevice.compare(cx, cy, _ref(CFG)))
    _assert_frag_equal(got, tdevice.compare(cx, cy, CFG, "cpu"))
    want_keys = ({"seeds", "extend", "merge"} if self_cmp else
                 {"revcomp", "index_x", "index_y", "join", "filter", "extend",
                  "merge"})
    assert set(timings) == want_keys
    assert got["xStart"].shape[0] > 0 and set(got["strand"]) == {0, 1}


@pytest.mark.parametrize("self_cmp", [True, False], ids=["self", "pair"])
def test_compare_timings_keys_are_the_references(self_cmp):
    """device.compare runs the reference's default, staged path and
    records its stage keys, no others."""
    cx, cy = _inputs(self_cmp)
    got, want = {}, {}
    tdevice.compare(cx, cy, CFG, "cpu", timings=got)
    jdevice.compare(cx, cy, _ref(CFG), timings=want)
    assert set(got) == set(want) and got


@pytest.mark.parametrize("self_cmp", [True, False], ids=["self", "pair"])
def test_resume_and_fingerprint(tmp_path, self_cmp):
    cx, cy = _inputs(self_cmp)
    want = tdevice.compare(cx, cy, CFG, "cpu")
    d = str(tmp_path / "ckpt")
    first = tdevice.compare(cx, cy, CFG, "cpu", keep_intermediates=d)
    files = _stage_files(d)
    fp = tcheckpoint.fingerprint(cx, cy, CFG)
    assert files == [f"stage_{fp}_{n}{s}.npz" for n in ("extend", "seeds")
                     for s in (0, 1)]
    timings = {}
    again = tdevice.compare(cx, cy, CFG, "cpu", keep_intermediates=d,
                            timings=timings)
    assert not set(HEAVY) & set(timings) and "merge" in timings, timings
    _assert_frag_equal(first, want)
    _assert_frag_equal(again, want)
    # another Config: another fingerprint, no stale reuse
    cfg2 = CFG.replace(min_len=60)
    other = tdevice.compare(cx, cy, cfg2, "cpu", keep_intermediates=d)
    assert len(_stage_files(d)) == 2 * len(files)
    _assert_frag_equal(other, orc.compare(cx, cy, _ref(cfg2)))


@pytest.mark.parametrize("self_cmp", [True, False], ids=["self", "pair"])
def test_fingerprint_is_the_jax_packages(self_cmp):
    cx, cy = _inputs(self_cmp)
    for cfg in (CFG, Config(), CFG.replace(min_identity=0.75)):
        assert repr(cfg) == repr(_ref(cfg))
        assert tcheckpoint.fingerprint(cx, cy, cfg) == \
            jcheckpoint.fingerprint(cx, cy, _ref(cfg))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, writer):
    """One package writes every stage file, the other resumes from them
    (no heavy stage runs) with the same output; one strand's extension
    file removed is recomputed by the reader, byte for byte the writer's
    arrays."""
    cx, cy = _inputs(True)
    d = str(tmp_path / "ckpt")

    def port(timings=None):
        return tdevice.compare(cx, cy, CFG, "cpu", keep_intermediates=d,
                               timings=timings)

    def jax(timings=None):
        return jdevice.compare(cx, cy, _ref(CFG), keep_intermediates=d,
                               timings=timings)

    first, second = (jax, port) if writer == "jax" else (port, jax)
    want = first()
    files = _stage_files(d)
    timings = {}
    _assert_frag_equal(second(timings), want)
    assert not set(HEAVY) & set(timings), timings
    assert _stage_files(d) == files
    path = os.path.join(d, [f for f in files if "extend1" in f][0])
    with np.load(path) as z:
        kept = {f: z[f] for f in z.files}
    os.remove(path)
    timings = {}
    _assert_frag_equal(second(timings), want)
    assert "extend" in timings and "seeds" not in timings, timings
    with np.load(path) as z:
        assert sorted(z.files) == sorted(kept)
        for f in z.files:
            assert z[f].dtype == kept[f].dtype, f
            assert np.array_equal(z[f], kept[f]), f


@pytest.mark.parametrize("mode", ["banded", "ungapped"])
@pytest.mark.parametrize("self_cmp", [True, False], ids=["self", "pair"])
def test_profile_stages_records(self_cmp, mode):
    cx, cy = _inputs(self_cmp)
    cfg = CFG.replace(extend_mode=mode)
    emitted = []
    got = tmetrics.profile_stages(cx, cy, cfg, emit=emitted.append,
                                  device="cpu")
    want = jmetrics.profile_stages(cx, cy, _ref(cfg))
    assert [r["stage"] for r in got] == [
        "h2d", "index_build", "seed_join", "hit_filter", "extension",
        "merge_accept", "families_host"]
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "wall_s"} == \
            {k: v for k, v in w.items() if k != "wall_s"}
        assert isinstance(g["wall_s"], float) and g["wall_s"] >= 0
    assert len(emitted) == len(got)
    assert got[2]["hits"] > 0 and got[-2]["fragments"] > 0
