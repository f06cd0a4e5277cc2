"""Masked-interval and family-summary writers (SURVEY.md §1 L5); the port's
copy of repkiller_tpu/report/intervals.py.

Repeat intervals are emitted BED-style (3 columns: name, 0-based start,
half-open end) so they drop straight into standard masking tools; the
family summary is a small CSV (family id, fragment count, best score,
total bp). Both derive from oracle.pipeline.repeat_intervals /
family_stats so every backend shares one definition.
"""

from __future__ import annotations

from typing import Dict, List, Optional, TextIO, Union

import numpy as np

from ..config import Config
from ..oracle import pipeline as orc
from ..utils import trace
from .csv_writer import count_bytes


def _emit_record_local(f, seqs, s: int, e: int) -> None:
    """Write interval [s, e] (inclusive, concatenated coords) as one BED
    row per overlapped record, record-local half-open coords. Parts that
    fall on inter-record N spacers are dropped."""
    offs = np.asarray(seqs.offsets)
    lens = np.asarray(seqs.lengths)
    r0 = max(0, int(np.searchsorted(offs, s, side="right")) - 1)
    r1 = max(0, int(np.searchsorted(offs, e, side="right")) - 1)
    for r in range(r0, r1 + 1):
        rs = max(s, int(offs[r]))
        re = min(e, int(offs[r]) + int(lens[r]) - 1)
        if rs <= re:
            f.write("%s\t%d\t%d\n" % (seqs.names[r], rs - int(offs[r]),
                                      re - int(offs[r]) + 1))


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
    ``intervals`` and, for a path, the ``bytes`` written."""
    iv = orc.repeat_intervals(frag, frag["group"], cfg, self_cmp)
    trace.count("intervals", sum(len(v) for v in iv.values()))
    close = False
    if isinstance(dst, str):
        f = open(dst, "w")
        close = True
    else:
        f = dst
    try:
        for space in sorted(iv):
            seqs = x_seqs if space == 0 else y_seqs
            name = x_name if space == 0 else y_name
            for s, e in iv[space]:
                if seqs is not None and seqs.offsets is not None:
                    _emit_record_local(f, seqs, int(s), int(e))
                else:
                    f.write("%s\t%d\t%d\n" % (name, int(s), int(e) + 1))
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
    stats = orc.family_stats(frag, frag["group"])
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
    """Hard-mask repeat intervals (inclusive int64[n,2]) to N in a uint8
    code array — the repeat-masking capability of the reference tool."""
    out = np.asarray(codes, np.uint8).copy()
    if intervals is None:
        return out
    for s, e in intervals:
        out[int(s) : int(e) + 1] = 4
    return out
