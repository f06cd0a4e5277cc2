"""The sharded backend's pairwise branch (dist/sharded._pairwise_sharded)
on a chromosome pair in miniature: strain B derived from A as the
benchmark's ``human_chr21_pair`` configuration derives its second
chromosome (1.23% substitutions, A's first two quarters swapped, an
insertion at the midpoint), A carrying planted families with inverted
copies. On CPU ``LocalMesh`` shapes (1, 1) and (2, 2) the table equals the
benchmark's plain reference (``rkbench/harness/reference.compare`` with
``codes_y``) field for field, families included, on strands f, r and fr;
and the branch records its spans and counters with the values the
lengths give. This file imports no JAX."""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest

from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
from repkiller_tpu_torch.utils import trace

from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "rkbench"))
from harness import genomes, reference  # noqa: E402

LENGTH = 6000
FAMS = [(400, 3, 0.05, 1), (150, 5, 0.08, 2), (250, 3, 0.0, 1)]
PROFILE = {"name": "chr21_b", "snp_rate": 0.0123, "swap": "quarter",
           "insertion_bp": 60}
SETTINGS = dict(k=16, max_occ=64, min_hit_dist=32, gate_stride=2048,
                match=4, mismatch=-4, x_drop=40, max_extend=256, band=15,
                gap_open=8, gap_extend=2, min_len=40, min_identity=0.6,
                proximity=32, len_ratio=0.5, min_family=2,
                extend_mode="banded", hit_capacity=1 << 14,
                seed_capacity=1 << 12)
SHAPES = [(1, 1), (2, 2)]


@pytest.fixture(scope="module")
def pair():
    a = genomes.plant(LENGTH, FAMS, 2**31 + 19)
    return a, genomes.derive_strain(a, PROFILE, 2**31 + 20)


def _mesh(shape):
    return make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("strands", ["f", "r", "fr"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_equals_the_plain_reference(pair, shape, strands):
    a, b = pair
    settings = {**SETTINGS, "strands": strands}
    got = compare_sharded(a, b, Config(**settings), _mesh(shape))
    want, work = reference.compare(a, reference.Params.from_dict(settings),
                                   codes_y=b)
    assert work["work"] > 0 and want["xStart"].shape[0] > 3
    assert set(want["strand"].tolist()) == {"fr".index(s) for s in strands}
    if "f" in strands:          # the swap and the insertion cut the diagonal
        assert (want["xStart"] - want["yStart"]).tolist().count(0) < \
            want["xStart"].shape[0]
    for f in reference.FIELDS + ("group",):
        assert np.array_equal(got[f].astype(np.int32), want[f]), f


def _spans(fn):
    """``fn()`` inside a trace job -> the job's spans other than its own."""
    with trace.job() as job_id:
        fn()
    return [s for s in trace.spans()
            if s["job"] == job_id and s["id"] != job_id]


@pytest.mark.parametrize("strands", ["f", "r", "fr"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_spans_and_counters(pair, shape, strands):
    """X's index span, then per strand: strand r's "sharded.revcomp",
    Y's (or revcomp(Y)'s) index span counting its positions, and a hits
    span counting the window k-mers this process's bodies join (each of
    X's positions once per shard)."""
    a, b = pair
    cfg = Config(**{**SETTINGS, "strands": strands})
    spans = _spans(lambda: compare_sharded(a, b, cfg, _mesh(shape)))
    names = collections.Counter(s["name"] for s in spans)
    n_str = len(strands)
    assert names["sharded.index"] == 1 + n_str
    assert names["sharded.hits"] == n_str
    assert names["sharded.revcomp"] == ("r" in strands)
    assert names["sharded.regroup"] == 0
    index = [s["counters"]["entries"] for s in spans
             if s["name"] == "sharded.index"]
    assert index == [a.shape[0] - cfg.k + 1] + [b.shape[0] - cfg.k + 1] * n_str
    queries = [s["counters"]["queries"] for s in spans
               if s["name"] == "sharded.hits"]
    assert queries == [shape[1] * (a.shape[0] - cfg.k + 1)] * n_str
    compare = next(s["id"] for s in spans if s["name"] == "compare")
    assert all(s["parent"] == compare for s in spans
               if s["name"] in ("sharded.revcomp", "sharded.index",
                                "sharded.hits"))
    assert all(s["device_s"] is None for s in spans)       # no card here


def test_self_path_spans_did_not_change(pair):
    """The canonical self path records no "sharded.revcomp" and no
    pairwise counters."""
    a, _ = pair
    spans = _spans(lambda: compare_sharded(
        a, None, Config(**{**SETTINGS, "strands": "fr"}), _mesh((1, 1))))
    assert "sharded.revcomp" not in {s["name"] for s in spans}
    assert not any({"entries", "queries"} & set(s["counters"]) for s in spans)
