"""The port's repeat-interval path against the JAX package's, exactly:
``table.repeat_intervals`` (the merge), ``report.intervals``'
``write_intervals_bed`` (text and the intervals it returns) and
``mask_codes``, and ``api.Result.masked_fasta``. Each case is a fragment
table over a SeqSet of records joined by 32-N spacers, as ``read_fasta``
joins them, chosen for one edge of the merge, the cut at record
boundaries, the mask or the 70-column lines."""

import dataclasses
import io

import numpy as np
import pytest

from repkiller_tpu import api as japi
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.io import fasta as jfasta
from repkiller_tpu.oracle import pipeline as jorc
from repkiller_tpu.report import intervals as jiv
from repkiller_tpu_torch import api as tapi, table
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.io import fasta as tfasta
from repkiller_tpu_torch.report import intervals as tiv

SPACER = 32


def _records(lengths, seed=0, names=None):
    """(codes, names, offsets, lengths) of records of these lengths, with
    a few N in them, joined by SPACER N codes."""
    rng = np.random.default_rng(seed)
    parts, offsets, pos = [], [], 0
    for i, n in enumerate(lengths):
        if i:
            parts.append(np.full(SPACER, 4, np.uint8))
            pos += SPACER
        offsets.append(pos)
        rec = rng.integers(0, 4, n).astype(np.uint8)
        rec[rng.random(n) < 0.01] = 4
        parts.append(rec)
        pos += n
    codes = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    names = names or ["chr%d" % i for i in range(len(lengths))]
    return (codes, names, np.asarray(offsets, np.int64),
            np.asarray(lengths, np.int64))


def _frag(pairs, group=None):
    """Fragment table of (xStart, xEnd, yStart, yEnd) rows; yStart > yEnd
    marks the reverse strand, as the pipeline reports it."""
    a = np.asarray(pairs, np.int64).reshape(-1, 4)
    n = a.shape[0]
    return {
        "xStart": a[:, 0].astype(np.int32), "xEnd": a[:, 1].astype(np.int32),
        "yStart": a[:, 2].astype(np.int32), "yEnd": a[:, 3].astype(np.int32),
        "strand": (a[:, 2] > a[:, 3]).astype(np.int32),
        "score": (a[:, 1] - a[:, 0] + 1).astype(np.int32),
        "length": (a[:, 1] - a[:, 0] + 1).astype(np.int32),
        "group": (np.zeros(n, np.int32) if group is None
                  else np.asarray(group, np.int32)),
    }


def _random_frag(n, total, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, total - 400, n)
    ln = rng.integers(12, 120, n)
    ys = rng.integers(0, total - 400, n)
    rev = rng.random(n) < 0.5
    ye = np.where(rev, ys, ys + ln - 1)
    ys = np.where(rev, ys + ln - 1, ys)
    return _frag(np.stack([xs, xs + ln - 1, ys, ye], 1),
                 rng.integers(0, n // 3, n))


def _case(name):
    """-> (frag, cfg, x records, y records or None for a self-comparison,
    offsets kept)."""
    if name == "touching_nested_duplicates":
        x = _records([600])
        return _frag([(10, 20, 21, 30),          # touching: one interval
                      (100, 200, 120, 150),      # nested
                      (300, 310, 300, 310),      # duplicates
                      (300, 310, 320, 330),
                      (400, 410, 412, 420),      # a one-base gap stays
                      (500, 540, 560, 520)]), Config(), x, None, True
    if name == "spacer_and_record_ends":
        x = _records([300, 400, 250])            # offsets 0, 332, 764
        return _frag([(280, 350, 305, 320),      # across a spacer; inside one
                      (250, 299, 700, 731),      # each ends on a last base
                      (1000, 1030, 990, 1040),   # ends past the array (1014)
                      (20, 60, 360, 400)]), Config(), x, None, True
    if name == "record_lengths":
        x = _records([0, 69, 70, 71, 140, 0])    # offsets 0, 32, 133, 235, 338, 510
        return _frag([(0, 40, 60, 240),          # over three records and spacers
                      (100, 101, 133, 202),      # a record's last base; a whole record
                      (300, 305, 338, 477),
                      (500, 509, 478, 486)]), Config(), x, None, True
    if name == "one_record":
        x = _records([1000], seed=1)
        return (_frag([(5, 80, 200, 275), (900, 999, 600, 501)]), Config(),
                x, None, True)
    if name == "three_records_random":
        x = _records([2_000_000, 3_500_000, 1_500_000], seed=2)
        return (_random_frag(24_000, 7_000_064, seed=3), Config(), x, None,
                True)
    if name == "offsets_none":
        x = _records([700], seed=4, names=["chrU"])
        return (_frag([(5, 80, 200, 275), (650, 720, 300, 250)]), Config(),
                x, None, False)
    if name == "cross":
        x = _records([400, 300], seed=5)
        y = _records([500], seed=6, names=["chrY"])
        return (_frag([(10, 90, 400, 320), (380, 450, 30, 100),
                       (600, 731, 100, 231), (100, 140, 480, 499)],
                      [0, 0, 1, 2]), Config(min_family=1), x, y, True)
    if name == "empty":
        return _frag([]), Config(), _records([300, 200]), None, True
    if name == "under_min_family":
        # min_family=5 copies: only family 3 (three fragments, six copies)
        x = _records([800, 800], seed=7)
        return (_frag([(10, 60, 100, 150), (200, 260, 300, 360),
                       (210, 250, 400, 440), (900, 960, 1000, 1060),
                       (910, 980, 1200, 1130), (1500, 1590, 1600, 1690)],
                      [1, 2, 2, 3, 3, 3]), Config(min_family=5), x, None,
                True)
    raise KeyError(name)


CASES = ["touching_nested_duplicates", "spacer_and_record_ends",
         "record_lengths", "one_record", "three_records_random",
         "offsets_none", "cross", "empty", "under_min_family"]


def _seqsets(recs, with_offsets):
    codes, names, offsets, lengths = recs
    if not with_offsets:
        return (tfasta.SeqSet(codes=codes, names=names),
                jfasta.SeqSet(codes=codes, names=names))
    return (tfasta.SeqSet(codes=codes, names=names, offsets=offsets,
                          lengths=lengths),
            jfasta.SeqSet(codes=codes, names=names, offsets=offsets,
                          lengths=lengths))


@pytest.fixture(params=CASES)
def case(request):
    frag, cfg, x, y, with_offsets = _case(request.param)
    tx, jx = _seqsets(x, with_offsets)
    ty, jy = _seqsets(y, with_offsets) if y is not None else (None, None)
    port = tapi.Result(frag=frag, cfg=cfg, x=tx, y=ty)
    ref = japi.Result(frag=frag, cfg=JConfig(**dataclasses.asdict(cfg)),
                      x=jx, y=jy)
    return port, ref


def _assert_intervals_equal(got, want):
    assert got.keys() == want.keys()
    for space in want:
        assert got[space].dtype == want[space].dtype == np.int64
        assert got[space].shape == want[space].shape
        assert np.array_equal(got[space], want[space])


def test_intervals_and_bed_match_reference(case):
    """The merge, and the BED rows both per record (with the SeqSets) and
    in concatenated coordinates under one name."""
    port, ref = case
    _assert_intervals_equal(port.repeat_intervals(), ref.repeat_intervals())
    got, want = io.StringIO(), io.StringIO()
    _assert_intervals_equal(port.write_intervals(got),
                            ref.write_intervals(want))
    assert got.getvalue() == want.getvalue()
    got, want = io.StringIO(), io.StringIO()
    tiv.write_intervals_bed(port.frag, port.cfg, got, port.self_cmp,
                            x_name="x", y_name="y")
    jiv.write_intervals_bed(ref.frag, ref.cfg, want, ref.self_cmp,
                            x_name="x", y_name="y")
    assert got.getvalue() == want.getvalue()


def test_mask_and_masked_fasta_match_reference(case):
    port, ref = case
    for space in (0, 1):
        iv = ref.repeat_intervals().get(space)
        codes = (ref.x if space == 0 else (ref.y or ref.x)).codes
        assert np.array_equal(tiv.mask_codes(codes, iv),
                              jiv.mask_codes(codes, iv))
        assert np.array_equal(port.masked_codes(space),
                              ref.masked_codes(space))
        assert port.masked_fasta(space) == ref.masked_fasta(space)


@pytest.mark.parametrize("intervals", [
    [[0, 0]], [[3, 5], [6, 9]], [[2, 4], [8, 100]], [[50, 60]],
    np.zeros((0, 2), np.int64), None,
    [[5, 9], [7, 12]], [[10, 12], [2, 3]], [[2, 15], [4, 6]], [[5, 3]],
    [[18, 40]], [[9, 4], [20, 25], [1, 2]], [[4, 8], [4, 8], [0, 1]]])
def test_mask_codes_edges_match_reference(intervals):
    """A first base, touching intervals, ends past the array, an interval
    wholly past it, none at all; and, as the reference masks each
    interval in turn, overlapping, unsorted, nested, empty (e < s) and
    repeated intervals."""
    codes = np.arange(30, dtype=np.uint8) % 4
    assert np.array_equal(tiv.mask_codes(codes, intervals),
                          jiv.mask_codes(codes, intervals))


def test_masked_fasta_of_no_records_matches_reference():
    """A SeqSet without names or offsets: one record named seq0."""
    codes = np.arange(141, dtype=np.uint8) % 5
    frag = _frag([(0, 9, 30, 39)])
    port = tapi.Result(frag=frag, cfg=Config(), x=tfasta.SeqSet(codes=codes))
    ref = japi.Result(frag=frag, cfg=JConfig(), x=jfasta.SeqSet(codes=codes))
    assert port.masked_fasta() == ref.masked_fasta()
    assert port.masked_fasta().startswith(">seq0 masked\n")


def test_merge_matches_reference_loop_on_random_intervals():
    """``table.union_intervals`` against the loop it replaced, on
    intervals that nest, touch and repeat."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, 5_000, 20_000)
    e = s + rng.integers(0, 40, 20_000)
    o = np.lexsort((e, s))
    s, e = s[o], e[o]
    merged, cs, ce = [], int(s[0]), int(e[0])
    for a, b in zip(s[1:].tolist(), e[1:].tolist()):
        if a <= ce + 1:
            ce = max(ce, b)
        else:
            merged.append((cs, ce))
            cs, ce = a, b
    merged.append((cs, ce))
    assert table.union_intervals(s, e).tolist() == [list(m) for m in merged]
    want = jorc.repeat_intervals(_frag(np.stack([s, e, s, e], 1)),
                                 np.zeros(s.shape[0], np.int32), JConfig(),
                                 True)[0]
    assert np.array_equal(want, merged)
