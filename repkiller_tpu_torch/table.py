"""The fragment table: its columns, its canonical order, and the repeat
intervals and family statistics derived from it. One definition shared by
every backend (the torch pipeline, the sharded and streamed drivers, the
numpy oracle) and by the writers.

A table is a dict of equal-length numpy columns, ``FRAG_FIELDS`` plus, once
clustered, a "group" column of family ids. Coordinates are inclusive.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import Config

FRAG_FIELDS = (
    "xStart", "yStart", "xEnd", "yEnd",  # inclusive, comparison-space coords
    "strand",                            # 0 = forward, 1 = reverse
    "length", "score", "idents",
)


def empty() -> Dict[str, np.ndarray]:
    """The table of no fragments, with its "group" column."""
    frag = {f: np.zeros(0, np.int32) for f in FRAG_FIELDS}
    frag["group"] = np.zeros(0, np.int32)
    return frag


def canonical_sort(frag: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Total-order canonical fragment ordering used for all final outputs:
    (strand, xStart, yStart, xEnd, yEnd)."""
    order = np.lexsort((frag["yEnd"], frag["xEnd"], frag["yStart"], frag["xStart"], frag["strand"]))
    return {k: v[order] for k, v in frag.items()}


def intervals_of(frag: Dict[str, np.ndarray], self_cmp: bool):
    """Each fragment contributes two genomic intervals (its two repeat copies).

    Returns (space, start, end, frag_idx): space 0 = X coords, 1 = Y coords
    (for self-comparison both copies live in the same space 0). Reverse-strand
    y intervals are normalised to (min,max) in comparison space — callers
    converting to original coordinates do so in the writer.
    """
    n = frag["xStart"].shape[0]
    xs, xe = frag["xStart"], frag["xEnd"]
    ys = np.minimum(frag["yStart"], frag["yEnd"])
    ye = np.maximum(frag["yStart"], frag["yEnd"])
    idx = np.arange(n, dtype=np.int64)
    space_y = np.zeros(n, np.int32) if self_cmp else np.ones(n, np.int32)
    space = np.concatenate([np.zeros(n, np.int32), space_y])
    start = np.concatenate([xs, ys]).astype(np.int64)
    end = np.concatenate([xe, ye]).astype(np.int64)
    fidx = np.concatenate([idx, idx])
    return space, start, end, fidx


def family_stats(frag: Dict[str, np.ndarray], group: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-family summary: id, n_fragments, span (bp covered on X), best score."""
    if group.shape[0] == 0:
        return {"family": np.zeros(0, np.int32), "n_frags": np.zeros(0, np.int32),
                "max_score": np.zeros(0, np.int32), "total_len": np.zeros(0, np.int64)}
    fams, inv = np.unique(group, return_inverse=True)
    nf = fams.shape[0]
    n_frags = np.bincount(inv, minlength=nf).astype(np.int32)
    max_score = np.zeros(nf, np.int32)
    np.maximum.at(max_score, inv, frag["score"])
    total_len = np.zeros(nf, np.int64)
    np.add.at(total_len, inv, frag["length"].astype(np.int64))
    return {"family": fams.astype(np.int32), "n_frags": n_frags,
            "max_score": max_score, "total_len": total_len}


def repeat_intervals(frag: Dict[str, np.ndarray], group: np.ndarray, cfg: Config,
                     self_cmp: bool) -> Dict[int, np.ndarray]:
    """Masked repeat intervals: union (pure-overlap merge) of the intervals of
    all fragments whose family has >= cfg.min_family repeat COPIES.

    Copies, not fragments: in a self-comparison each fragment certifies
    TWO copies (its x and y intervals both live in the genome), so a
    single-fragment family is already a 2-copy repeat and passes the
    default min_family=2. Cross-comparison fragments contribute one copy
    per genome, so there the count is the fragment count.

    Returns {space: int -> int64[n,2] (start, end inclusive)} per coordinate
    space (0 = X, 1 = Y for cross-comparisons).
    """
    out: Dict[int, np.ndarray] = {}
    n = group.shape[0]
    if n == 0:
        return out
    fams, inv = np.unique(group, return_inverse=True)
    sizes = np.bincount(inv, minlength=fams.shape[0])
    copies = (2 if self_cmp else 1) * sizes
    is_rep = copies[inv] >= cfg.min_family
    sel = {k: v[is_rep] for k, v in frag.items()}
    space, start, end, _ = intervals_of(sel, self_cmp)
    for sp in np.unique(space):
        m = space == sp
        s, e = start[m], end[m]
        o = np.lexsort((e, s))
        out[int(sp)] = union_intervals(s[o], e[o])
    return out


def union_intervals(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Union of inclusive intervals (s, e), e >= s, sorted by (s, e):
    int64[n, 2]. An interval opens a new run where it starts more than one
    base past the running maximum of the ends before it, so touching
    intervals (s == end + 1) merge; a run ends at that maximum."""
    run_end = np.maximum.accumulate(e)
    first = np.flatnonzero(np.concatenate([[True], s[1:] > run_end[:-1] + 1]))
    merged = np.empty((first.shape[0], 2), np.int64)
    merged[:, 0] = s[first]
    merged[:, 1] = run_end[np.append(first[1:], s.shape[0]) - 1]
    return merged
