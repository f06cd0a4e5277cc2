"""Masked-interval and family-summary writers (SURVEY.md §1 L5); the port's
copy of repkiller_tpu/report/intervals.py.

Repeat intervals are emitted BED-style (3 columns: name, 0-based start,
half-open end) so they drop straight into standard masking tools; the
family summary is a small CSV (family id, fragment count, best score,
total bp). Both derive from table.repeat_intervals / family_stats, the
fragment table's one definition, which every backend shares.
"""

from __future__ import annotations

from typing import Dict, List, Optional, TextIO, Union

import numpy as np

from ..config import Config
from ..table import family_stats, repeat_intervals, union_intervals
from ..utils import trace
from .csv_writer import count_bytes


def _record_pieces(seqs, iv: np.ndarray):
    """Cut merged intervals iv (inclusive, concatenated coords) at record
    boundaries: (record index, record-local start, half-open end) of each
    piece, in interval then record order, pieces on inter-record N
    spacers dropped; and how many intervals gave more than one piece."""
    offs = np.asarray(seqs.offsets, np.int64)
    lens = np.asarray(seqs.lengths, np.int64)
    s, e = iv[:, 0], iv[:, 1]
    r0 = np.maximum(np.searchsorted(offs, s, side="right") - 1, 0)
    r1 = np.maximum(np.searchsorted(offs, e, side="right") - 1, 0)
    n_rec = r1 - r0 + 1
    which = np.repeat(np.arange(s.shape[0]), n_rec)
    r = r0[which] + np.arange(which.shape[0]) - np.repeat(
        np.cumsum(n_rec) - n_rec, n_rec)
    rs = np.maximum(s[which], offs[r])
    re = np.minimum(e[which], offs[r] + lens[r] - 1)
    keep = rs <= re
    split = int(np.count_nonzero(
        np.bincount(which[keep], minlength=s.shape[0]) > 1))
    r, rs, re = r[keep], rs[keep], re[keep]
    return r, rs - offs[r], re - offs[r] + 1, split


def _rows(names, start: np.ndarray, end: np.ndarray) -> str:
    """BED rows "name, start, end" in one format call; ``names`` is one
    name or an object array of one per row."""
    table = np.empty((start.shape[0], 3), object)
    table[:, 0] = names
    table[:, 1] = start
    table[:, 2] = end
    return ("%s\t%d\t%d\n" * start.shape[0]) % tuple(
        table.ravel().tolist())


@trace.traced("report.bed")
def write_intervals_bed(
    frag: Dict[str, np.ndarray],
    cfg: Config,
    dst: Union[str, TextIO],
    self_cmp: bool,
    x_name: str = "seqX",
    y_name: str = "seqY",
    x_seqs=None,
    y_seqs=None,
) -> Dict[int, np.ndarray]:
    """Merge repeat-family intervals and write BED; returns the intervals
    per coordinate space (0 = X, 1 = Y for cross-comparisons).

    With x_seqs/y_seqs (SeqSet), rows are per-record with record-local
    coordinates — the multi-record masking path (e.g. chr2L+chr2R in one
    FASTA); otherwise one name per space with concatenated coordinates.
    Each call is a "report.bed" trace span that counts the
    ``intervals``, the ``split`` ones (those that straddle a record
    boundary and so give more than one row) and, for a path, the
    ``bytes`` written."""
    iv = repeat_intervals(frag, frag["group"], cfg, self_cmp)
    trace.count("intervals", sum(len(v) for v in iv.values()))
    text, split = [], 0
    for space in sorted(iv):
        seqs = x_seqs if space == 0 else y_seqs
        if seqs is not None and seqs.offsets is not None:
            r, start, end, n = _record_pieces(seqs, iv[space])
            text.append(_rows(np.asarray(seqs.names, object)[r], start, end))
            split += n
        else:
            name = x_name if space == 0 else y_name
            text.append(_rows(name, iv[space][:, 0], iv[space][:, 1] + 1))
    trace.count("split", split)
    close = False
    if isinstance(dst, str):
        f = open(dst, "w")
        close = True
    else:
        f = dst
    try:
        f.write("".join(text))
    finally:
        if close:
            f.close()
    count_bytes(dst)
    return iv


@trace.traced("report.summary")
def write_family_summary(
    frag: Dict[str, np.ndarray], dst: Union[str, TextIO]
) -> Dict[str, np.ndarray]:
    """Per-family stats CSV; returns the stats dict. Each call is a
    "report.summary" trace span that counts the ``rows`` (families) and,
    for a path, the ``bytes`` written."""
    stats = family_stats(frag, frag["group"])
    trace.count("rows", int(stats["family"].shape[0]))
    close = False
    if isinstance(dst, str):
        f = open(dst, "w")
        close = True
    else:
        f = dst
    try:
        f.write("family,n_frags,max_score,total_len\n")
        for i in range(stats["family"].shape[0]):
            f.write("%d,%d,%d,%d\n" % (
                int(stats["family"][i]), int(stats["n_frags"][i]),
                int(stats["max_score"][i]), int(stats["total_len"][i])))
    finally:
        if close:
            f.close()
    count_bytes(dst)
    return stats


def mask_codes(
    codes: np.ndarray, intervals: Optional[np.ndarray]
) -> np.ndarray:
    """Hard-mask repeat intervals (inclusive int64[n,2], non-negative) to N
    in a uint8 code array, as the reference masks each interval in turn —
    the repeat-masking capability of the reference tool. Intervals sorted
    and disjoint, as ``repeat_intervals`` gives them, are masked in one
    pass; any others are first sorted and unioned, an interval with e < s
    masking nothing. Ends past the array are clipped."""
    out = np.asarray(codes, np.uint8).copy()
    if intervals is None:
        return out
    n = out.shape[0]
    iv = np.asarray(intervals, np.int64).reshape(-1, 2) + [0, 1]
    if (np.diff(iv.ravel()) < 0).any():
        s, e = iv[:, 0], iv[:, 1] - 1
        keep = e >= s
        s, e = s[keep], e[keep]
        o = np.lexsort((e, s))
        iv = (union_intervals(s[o], e[o]) if o.size else iv[:0]) + [0, 1]
    bounds = np.concatenate([[0], np.minimum(iv.ravel(), n), [n]])
    inside = np.zeros(bounds.shape[0] - 1, bool)
    inside[1::2] = True
    np.putmask(out, np.repeat(inside, np.diff(bounds)), 4)
    return out
