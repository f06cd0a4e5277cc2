"""Pure-numpy oracle for the full repeat-detection pipeline: the port's copy
of repkiller_tpu/oracle/pipeline.py, unchanged below this docstring but for
the fragment table's format and rules (FRAG_FIELDS, canonical_sort,
_intervals_of, family_stats, repeat_intervals, _merge_sorted), which it
takes from table.py under their old names.

This oracle is the executable spec (SURVEY.md §4.1). Every device stage
must match it bit-identically; it runs behind ``backend="oracle"``.

Stages (SURVEY.md §3.2/§3.3):
  codes -> k-mer index -> seed hits -> diagonal filter -> extension
        -> per-diagonal merge -> acceptance -> repeat families -> outputs

Design notes on determinism (SURVEY.md §7 "Hard parts" #1): every sort uses a
total-order key; every tie-break is explicit; the vectorised x-drop extension
semantics (hard cap ``max_extend``, first-argmax endpoint) are defined HERE and
replicated exactly on device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import Config
from ..io import codec
from ..table import (FRAG_FIELDS, canonical_sort, family_stats,  # noqa: F401
                     intervals_of as _intervals_of, repeat_intervals,
                     union_intervals as _merge_sorted)

NEG_INF = np.int32(-(1 << 30))

# --------------------------------------------------------------------------
# k-mer extraction + index (SURVEY.md §2.2 "k-mer index build")
# --------------------------------------------------------------------------

def extract_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All valid k-mers of `codes` -> (kmer uint32[n], pos int32[n]).

    Big-endian base packing: first base in the highest 2 bits of the k*2-bit
    value. A k-mer is valid iff its window contains no N (code 4).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    # sliding windows via stride trick equivalent: cumulative shift-add
    km = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        w = codes[i : i + n]
        km = (km << np.uint64(2)) | np.where(w < 4, w, 0).astype(np.uint64)
        valid &= w < 4
    return km[valid].astype(np.uint32), np.nonzero(valid)[0].astype(np.int32)


def build_index(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (kmer, pos) arrays — lexicographic ascending (kmer, then pos)."""
    km, pos = extract_kmers(codes, k)
    order = np.lexsort((pos, km))
    return km[order], pos[order]


# --------------------------------------------------------------------------
# seed hits (SURVEY.md §2.2 "Hit finding")
# --------------------------------------------------------------------------

def find_hits(
    idxX: Tuple[np.ndarray, np.ndarray],
    idxY: Tuple[np.ndarray, np.ndarray],
    cfg: Config,
    self_mode: Optional[str] = None,
    y_len: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Join two sorted k-mer indices -> hit arrays (px, py) int32.

    - A k-mer occurring > cfg.max_occ times in either index is skipped
      entirely (deterministic hyper-repeat cap).
    - self_mode "f": X vs itself forward — keep px < py only (canonical half,
      excludes the trivial self-diagonal).
    - self_mode "r": X vs revcomp(X) — keep px < y_anchor where
      y_anchor = y_len - py - k is the hit's start in original coords;
      px == y_anchor (a seed that is its own reverse complement) is kept once.
    """
    kx, px = idxX
    ky, py = idxY
    # unique kmers + counts on each side
    ux, startx = np.unique(kx, return_index=True)
    cntx = np.diff(np.append(startx, kx.shape[0]))
    uy, starty = np.unique(ky, return_index=True)
    cnty = np.diff(np.append(starty, ky.shape[0]))

    # intersect
    common, ix, iy = np.intersect1d(ux, uy, return_indices=True)
    cx, cy = cntx[ix], cnty[iy]
    keep = (cx <= cfg.max_occ) & (cy <= cfg.max_occ)
    sx, sy, cx, cy = startx[ix][keep], starty[iy][keep], cx[keep], cy[keep]

    # expand all (px, py) pairs per shared kmer, X-major then Y (canonical order)
    hpx, hpy = [], []
    for a, b, na, nb in zip(sx, sy, cx, cy):
        xs = px[a : a + na]
        ys = py[b : b + nb]
        hpx.append(np.repeat(xs, nb))
        hpy.append(np.tile(ys, na))
    if hpx:
        hpx = np.concatenate(hpx).astype(np.int32)
        hpy = np.concatenate(hpy).astype(np.int32)
    else:
        hpx = np.zeros(0, np.int32)
        hpy = np.zeros(0, np.int32)

    if self_mode == "f":
        m = hpx < hpy
        hpx, hpy = hpx[m], hpy[m]
    elif self_mode == "r":
        y_anchor = y_len - hpy - np.int32(len_k(cfg))
        m = hpx <= y_anchor
        hpx, hpy = hpx[m], hpy[m]
    return hpx, hpy


def len_k(cfg: Config) -> int:
    return cfg.k


# --------------------------------------------------------------------------
# diagonal filter (SURVEY.md §2.2 "Hit filtering"; chain/ layer in §1)
# --------------------------------------------------------------------------

def filter_hits(px: np.ndarray, py: np.ndarray, cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the first hit per (diagonal, px // min_hit_dist) bucket.

    Bucket-quantised thinning: fully parallel and shard-invariant, unlike the
    sequential "distance to last kept" walk. Hits are first sorted by
    (diag, px) — a total order because (diag, px) determines py.
    """
    if px.shape[0] == 0:
        return px, py
    diag = px.astype(np.int64) - py.astype(np.int64)
    order = np.lexsort((px, diag))
    px, py, diag = px[order], py[order], diag[order]
    bucket = px.astype(np.int64) // cfg.min_hit_dist
    first = np.ones(px.shape[0], dtype=bool)
    first[1:] = (diag[1:] != diag[:-1]) | (bucket[1:] != bucket[:-1])
    return px[first], py[first]


# --------------------------------------------------------------------------
# coverage gating (SURVEY.md §1 L3 "chaining" / §2.2 "Extension": the
# GECKO-FragHits skip of hits already covered by a previous fragment on the
# same diagonal, reformulated deterministically: the first seed of every
# (diagonal, px // gate_stride) bucket is an anchor and always extends; a
# later seed of the bucket is skipped iff its k-mer window [px, px+k-1]
# lies inside its anchor's fragment x-extent. Bucket-local coverage makes
# the decision a pure function of the bucket's seeds, hence invariant to
# sharding and to window splits at gate_stride multiples.)
# --------------------------------------------------------------------------

def gate_anchors(px: np.ndarray, py: np.ndarray, cfg: Config) -> np.ndarray:
    """Anchor mask over seeds sorted by (diag, px): True for the first seed
    of each (diagonal, px // gate_stride) bucket."""
    n = px.shape[0]
    anchor = np.ones(n, dtype=bool)
    if n == 0:
        return anchor
    diag = px.astype(np.int64) - py.astype(np.int64)
    bucket = px.astype(np.int64) // cfg.gate_stride
    anchor[1:] = (diag[1:] != diag[:-1]) | (bucket[1:] != bucket[:-1])
    return anchor


def extend_gated(px: np.ndarray, py: np.ndarray,
                 cx: np.ndarray, cy: np.ndarray,
                 cfg: Config) -> Dict[str, np.ndarray]:
    """Extension with coverage gating (gate_stride > 0) or plain extension.

    Seeds MUST be sorted by (diag, px) — filter_hits' output order. Gated
    seeds produce no fragment; the result is anchors' fragments followed by
    surviving non-anchors' (order is irrelevant: merge_fragments re-sorts).
    """
    if cfg.gate_stride <= 0 or px.shape[0] == 0:
        return _extend_dispatch(px, py, cx, cy, cfg)
    anchor = gate_anchors(px, py, cfg)
    fa = _extend_dispatch(px[anchor], py[anchor], cx, cy, cfg)
    ordinal = np.cumsum(anchor) - 1          # each seed's bucket-anchor slot
    a_s, a_e = fa["xStart"][ordinal], fa["xEnd"][ordinal]
    covered = (~anchor) & (a_s <= px) & (a_e >= px + cfg.k - 1)
    surv = (~anchor) & (~covered)
    fs = _extend_dispatch(px[surv], py[surv], cx, cy, cfg)
    return {f: np.concatenate([fa[f], fs[f]]) for f in FRAG_FIELDS}


# --------------------------------------------------------------------------
# ungapped x-drop extension (SURVEY.md §2.2 "Extension", ungapped family)
# --------------------------------------------------------------------------

def _directional_gain(eq: np.ndarray, valid: np.ndarray, cfg: Config):
    """Vectorised x-drop scan for one direction.

    eq, valid: bool[n_seeds, E] — per-step match flag and in-bounds flag.
    Returns (ext_len, gain, idents) int32[n_seeds]: the number of steps taken,
    the score gain, and identities gained, under the spec:

      s_i  = cumsum(match ? +match : mismatch)        (i = 0..E-1)
      stop at the first i that is invalid or where s_i <= cummax(s)_i - x_drop
      endpoint = first argmax of [0, s_0, ..., s_{t-1}]  (0 = no extension)
    """
    n, E = eq.shape
    delta = np.where(eq, np.int32(cfg.match), np.int32(cfg.mismatch)).astype(np.int32)
    s = np.cumsum(delta, axis=1, dtype=np.int32)
    run_max = np.maximum.accumulate(np.maximum(s, 0), axis=1)
    stop = (~valid) | (s <= run_max - np.int32(cfg.x_drop))
    # t = first stop index (E if none)
    any_stop = stop.any(axis=1)
    t = np.where(any_stop, np.argmax(stop, axis=1), E).astype(np.int32)
    alive = np.arange(E, dtype=np.int32)[None, :] < t[:, None]
    s_masked = np.where(alive, s, NEG_INF)
    # candidates: index 0 == "no extension" with score 0
    cand = np.concatenate([np.zeros((n, 1), np.int32), s_masked], axis=1)
    ext = np.argmax(cand, axis=1).astype(np.int32)  # first argmax
    gain = cand[np.arange(n), ext]
    idents = np.cumsum(eq, axis=1, dtype=np.int32)
    idents = np.concatenate([np.zeros((n, 1), np.int32), idents], axis=1)
    idok = idents[np.arange(n), ext]
    return ext, gain, idok


def extend_ungapped(
    px: np.ndarray, py: np.ndarray,
    cx: np.ndarray, cy: np.ndarray,
    cfg: Config,
) -> Dict[str, np.ndarray]:
    """Extend each seed (px,py) into a fragment with independent left/right
    x-drop scans capped at cfg.max_extend. Returns a fragment dict (unmerged).

    cx/cy are uint8 code arrays in COMPARISON space (cy already revcomp'ed
    for reverse-strand comparisons).
    """
    n = px.shape[0]
    E = cfg.max_extend
    k = cfg.k
    Lx, Ly = cx.shape[0], cy.shape[0]
    if n == 0:
        return {f: np.zeros(0, np.int32) for f in FRAG_FIELDS}

    off = np.arange(E, dtype=np.int32)
    # right: positions px+k+i, py+k+i
    rx = px[:, None] + k + off[None, :]
    ry = py[:, None] + k + off[None, :]
    rvalid = (rx < Lx) & (ry < Ly)
    rxc = np.where(rvalid, rx, 0)
    ryc = np.where(rvalid, ry, 0)
    xa, ya = cx[rxc], cy[ryc]
    req = rvalid & (xa == ya) & (xa < 4)
    rext, rgain, rid = _directional_gain(req, rvalid, cfg)

    # left: positions px-1-i, py-1-i
    lx = px[:, None] - 1 - off[None, :]
    ly = py[:, None] - 1 - off[None, :]
    lvalid = (lx >= 0) & (ly >= 0)
    lxc = np.where(lvalid, lx, 0)
    lyc = np.where(lvalid, ly, 0)
    xa, ya = cx[lxc], cy[lyc]
    leq = lvalid & (xa == ya) & (xa < 4)
    lext, lgain, lid = _directional_gain(leq, lvalid, cfg)

    seed_score = np.int32(k * cfg.match)
    frag = {
        "xStart": (px - lext).astype(np.int32),
        "yStart": (py - lext).astype(np.int32),
        "xEnd": (px + k - 1 + rext).astype(np.int32),
        "yEnd": (py + k - 1 + rext).astype(np.int32),
        "strand": np.zeros(n, np.int32),
        "score": (seed_score + lgain + rgain).astype(np.int32),
        "idents": (k + lid + rid).astype(np.int32),
    }
    frag["length"] = (frag["xEnd"] - frag["xStart"] + 1).astype(np.int32)
    return frag


# --------------------------------------------------------------------------
# per-diagonal merge (SURVEY.md §2.2 "Fragment dedup/merge")
# --------------------------------------------------------------------------

def merge_fragments(frag: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Within each (strand, diagonal), collapse runs of overlapping fragments
    to the single best one.

    Sorted by (strand, diag, xStart, yStart); a fragment starts a new run iff
    its xStart exceeds the running max xEnd of the current run. Within a run,
    the winner maximises (score, length, -xStart, -yStart) — i.e. highest
    score, then longest, then leftmost.
    """
    n = frag["xStart"].shape[0]
    if n == 0:
        return frag
    diag = frag["xStart"].astype(np.int64) - frag["yStart"].astype(np.int64)
    order = np.lexsort((frag["yStart"], frag["xStart"], diag, frag["strand"]))
    f = {k: v[order] for k, v in frag.items()}
    diag = diag[order]

    # run boundaries via running max of xEnd within (strand, diag) groups
    new_group = np.ones(n, dtype=bool)
    new_group[1:] = (diag[1:] != diag[:-1]) | (f["strand"][1:] != f["strand"][:-1])
    run_id = np.empty(n, dtype=np.int64)
    cur_run = -1
    run_max_end = -1
    for i in range(n):  # O(n) host sweep; device version uses a segmented scan
        if new_group[i] or f["xStart"][i] > run_max_end:
            cur_run += 1
            run_max_end = f["xEnd"][i]
        else:
            run_max_end = max(run_max_end, int(f["xEnd"][i]))
        run_id[i] = cur_run

    # winner per run: lexicographic max on (score, length, -xStart, -yStart)
    best = {}
    for i in range(n):
        r = run_id[i]
        key = (int(f["score"][i]), int(f["length"][i]), -int(f["xStart"][i]), -int(f["yStart"][i]))
        if r not in best or key > best[r][0]:
            best[r] = (key, i)
    keep = np.array(sorted(idx for _, idx in best.values()), dtype=np.int64)
    return {k: v[keep] for k, v in f.items()}


def accept_fragments(frag: Dict[str, np.ndarray], cfg: Config) -> Dict[str, np.ndarray]:
    """Length + identity thresholds. Identity test uses integer math:
    idents * 100 >= ceil(min_identity*100) * length — no float comparisons."""
    pct = int(round(cfg.min_identity * 100))
    m = (frag["length"] >= cfg.min_len) & (frag["idents"] * 100 >= pct * frag["length"])
    return {k: v[m] for k, v in frag.items()}


# --------------------------------------------------------------------------
# repeat families (repkiller proper — SURVEY.md §2.1 "Grouping heuristics")
# --------------------------------------------------------------------------

class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, a):
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # canonical: smaller index is the root
            if ra > rb:
                ra, rb = rb, ra
            self.p[rb] = ra


def cluster_families(frag: Dict[str, np.ndarray], cfg: Config, self_cmp: bool) -> np.ndarray:
    """Group fragments into repeat families (repkiller's core capability).

    Link rule: fragments A,B are in the same family if any interval of A
    overlaps any interval of B in the same coordinate space within
    cfg.proximity bp, AND their lengths are compatible:
    min(lenA,lenB) >= cfg.len_ratio * max(lenA,lenB). Transitive closure via
    union-find. Family id = smallest member index under canonical_sort order.

    Fragments MUST already be canonical_sort'ed.
    """
    n = frag["xStart"].shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    space, start, end, fidx = _intervals_of(frag, self_cmp)
    order = np.lexsort((end, start, space))
    space, start, end, fidx = space[order], start[order], end[order], fidx[order]
    lens = frag["length"].astype(np.int64)

    uf = _UF(n)
    m = space.shape[0]
    # sweep: active set of intervals whose (end + proximity) >= current start
    active: list = []  # (end, frag_idx) — small for real data
    prev_space = -1
    for i in range(m):
        if space[i] != prev_space:
            active.clear()
            prev_space = space[i]
        s, e, fi = start[i], end[i], fidx[i]
        active = [(ae, afi) for (ae, afi) in active if ae + cfg.proximity >= s]
        for ae, afi in active:
            if afi == fi:
                continue
            la, lb = lens[afi], lens[fi]
            if min(la, lb) * 100 >= int(round(cfg.len_ratio * 100)) * max(la, lb):
                uf.union(int(afi), int(fi))
        active.append((e, fi))
    roots = np.array([uf.find(i) for i in range(n)], dtype=np.int32)
    return roots


# --------------------------------------------------------------------------
# end-to-end (SURVEY.md §3.3)
# --------------------------------------------------------------------------

def to_original_y(frag: Dict[str, np.ndarray], y_len: int) -> Dict[str, np.ndarray]:
    """Map reverse-strand y coords from revcomp space to original coordinates.

    GECKO convention: reverse fragments report yStart > yEnd (both in original
    coords). Forward fragments are untouched. Must run after merge (which
    operates in comparison space) and before clustering/writers (which need
    genomic coordinates).
    """
    r = frag["strand"] == 1
    ys, ye = frag["yStart"], frag["yEnd"]
    out = dict(frag)
    out["yStart"] = np.where(r, np.int32(y_len) - 1 - ys, ys).astype(np.int32)
    out["yEnd"] = np.where(r, np.int32(y_len) - 1 - ye, ye).astype(np.int32)
    return out


def compare(
    codesX: np.ndarray,
    codesY: Optional[np.ndarray],
    cfg: Config,
) -> Dict[str, np.ndarray]:
    """Full oracle pipeline. codesY=None => self-comparison of X.

    Returns the canonical fragment dict with a "group" family column; all
    coordinates are original-genome coordinates (reverse-strand fragments
    have yStart > yEnd per the GECKO CSV convention).
    """
    self_cmp = codesY is None
    cy_f = codesX if self_cmp else codesY
    frags = []

    idxX = build_index(codesX, cfg.k)
    if "f" in cfg.strands:
        idxY = idxX if self_cmp else build_index(cy_f, cfg.k)
        px, py = find_hits(idxX, idxY, cfg, self_mode="f" if self_cmp else None)
        px, py = filter_hits(px, py, cfg)
        fr = extend_gated(px, py, codesX, cy_f, cfg)
        fr["strand"][:] = 0
        frags.append(fr)
    if "r" in cfg.strands:
        cy_r = codec.revcomp_codes(cy_f)
        idxYr = build_index(cy_r, cfg.k)
        px, py = find_hits(idxX, idxYr, cfg,
                           self_mode="r" if self_cmp else None,
                           y_len=cy_r.shape[0])
        px, py = filter_hits(px, py, cfg)
        fr = extend_gated(px, py, codesX, cy_r, cfg)
        fr["strand"][:] = 1
        frags.append(fr)

    frag = {k: np.concatenate([f[k] for f in frags]) for k in FRAG_FIELDS} if frags else \
        {k: np.zeros(0, np.int32) for k in FRAG_FIELDS}
    frag = merge_fragments(frag)
    frag = accept_fragments(frag, cfg)
    frag = to_original_y(frag, cy_f.shape[0])
    frag = canonical_sort(frag)
    frag["group"] = cluster_families(frag, cfg, self_cmp)
    return frag


def _extend_dispatch(px, py, cx, cy, cfg: Config):
    if cfg.extend_mode == "ungapped":
        return extend_ungapped(px, py, cx, cy, cfg)
    from . import banded  # local import; numpy banded Gotoh oracle
    return banded.extend_banded(px, py, cx, cy, cfg)
