"""Plain reference of a genome job's comparison: the fragment table and the
family labels, worked out again from the genome's codes.

The semantics are those of the program's executable spec (the numpy
oracle, ``oracle/pipeline.py`` and ``oracle/banded.py``), written here
afresh in plain torch ops so that they run at genome scale on whatever
device they are given. Nothing of the program is imported.

- seeds: every valid k-mer (no N in its window); k-mers occurring more than
  ``max_occ`` times on either side are skipped. Strand f joins X with
  itself and keeps px < py; strand r joins X with revcomp(X) and keeps
  px <= L - py - k. The hits are thinned to the first of each (diagonal,
  px // min_hit_dist) bucket in (diagonal, px) order.
- gating: the first seed of each (diagonal, px // gate_stride) bucket is an
  anchor and extends; a later seed extends unless its k-mer window lies
  inside its anchor's fragment x-extent.
- extension: right and left of the seed, ungapped x-drop or banded Gotoh
  x-drop (the oracle's cell recurrences, tie rules and endpoint rule), at
  most ``max_extend`` steps or rows a side.
- merge: within each (strand, diagonal), runs of overlapping fragments
  collapse to the best by (score, length, -xStart, -yStart), exact ties
  to the smallest (xEnd, yEnd, idents); then the
  length and identity thresholds, reverse-strand y to original
  coordinates, and the canonical order (strand, xStart, yStart, xEnd,
  yEnd).
- families: two fragments link when intervals of theirs in one coordinate
  space lie within ``proximity`` bp and their lengths are within
  ``len_ratio``; a family's id is its smallest member's index.

A pairwise comparison of X with Y (``codes_y``) follows the oracle's
pairwise semantics: strand f joins X's k-mers with Y's, strand r with
revcomp(Y)'s, with ``max_occ`` applied on each side and no filter on
(px, py); the seeds extend against Y and revcomp(Y), the merge maps
reverse-strand y back with Y's length, and the families link intervals
within X and within Y, two spaces.

Besides the table, ``compare`` counts the work each extension needs: the
rows each seed's banded DP runs, or the steps each seed's ungapped scan
examines, up to and including the one where it stops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

NEG = -(1 << 30)
I32, I64 = torch.int32, torch.int64
FIELDS = ("xStart", "yStart", "xEnd", "yEnd", "strand", "length", "score",
          "idents")
CHUNK = 32                     # ungapped steps per vectorised chunk
COMPACT = 8                    # banded rows between compactions
TASK_BLOCK = 1 << 22           # extension tasks run together at most


@dataclass(frozen=True)
class Params:
    """The settings the comparison depends on (the configuration file's
    ``config`` block with the traffic's ``extend_mode``)."""

    k: int
    max_occ: int
    min_hit_dist: int
    gate_stride: int
    extend_mode: str
    match: int
    mismatch: int
    x_drop: int
    max_extend: int
    band: int
    gap_open: int
    gap_extend: int
    min_len: int
    min_identity: float
    proximity: int
    len_ratio: float
    min_family: int
    strands: str

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        return cls(**{f: d[f] for f in cls.__dataclass_fields__})


# ---------------------------------------------------------------- seeds

def kmer_index(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Valid k-mers of ``codes`` sorted by (k-mer, position) -> (kmer,
    pos), both int64."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        z = torch.zeros(0, dtype=I64, device=codes.device)
        return z, z
    km = torch.zeros(n, dtype=I64, device=codes.device)
    valid = torch.ones(n, dtype=torch.bool, device=codes.device)
    for i in range(k):
        w = codes[i : i + n].to(I64)
        km = km * 4 + torch.where(w < 4, w, 0)
        valid &= w < 4
    pos = torch.nonzero(valid)[:, 0]
    km = km[pos]
    km, order = torch.sort(km, stable=True)
    return km, pos[order]


def _groups(km: torch.Tensor):
    uniq, counts = torch.unique_consecutive(km, return_counts=True)
    return uniq, counts, torch.cumsum(counts, 0) - counts


def _expand(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For blocks of the given sizes -> (block of each slot, slot's offset
    within its block)."""
    total = int(counts.sum()) if counts.numel() else 0
    dev = counts.device
    block = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                    counts, output_size=total)
    start = torch.cumsum(counts, 0) - counts
    return block, torch.arange(total, device=dev) - start[block]


def self_hits_f(km, pos, max_occ: int):
    """Pairs of positions sharing a k-mer, px < py."""
    _, counts, starts = _groups(km)
    g_of, t = _expand(counts)
    c = counts[g_of]
    later = torch.where(c <= max_occ, c - 1 - t, 0)
    a, off = _expand(later)
    return pos[a], pos[a + 1 + off]


def cross_hits(km, pos, km_y, pos_y, max_occ: int):
    """Pairs (px in X, py in Y) sharing a k-mer that occurs at most
    ``max_occ`` times on each side."""
    ux, cx, sx = _groups(km)
    uy, cy, sy = _groups(km_y)
    h = torch.searchsorted(uy, ux).clamp(max=max(uy.shape[0] - 1, 0))
    found = (uy[h] == ux) if uy.numel() else torch.zeros_like(ux, dtype=torch.bool)
    keep = found & (cx <= max_occ) & (cy[h] <= max_occ)
    g_of, _ = _expand(cx)                       # X group of each X slot
    reps = torch.where(keep[g_of], cy[h[g_of]], 0)
    a, off = _expand(reps)
    b = sy[h[g_of[a]]] + off
    return pos[a], pos_y[b]


def self_hits_r(km, pos, km_r, pos_r, max_occ: int, L: int, k: int):
    """Pairs (px in X, py in revcomp(X)) sharing a k-mer, px <= L - py - k."""
    px, py = cross_hits(km, pos, km_r, pos_r, max_occ)
    m = px <= L - py - k
    return px[m], py[m]


def _first_of_runs(*keys: torch.Tensor) -> torch.Tensor:
    n = keys[0].shape[0]
    first = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=keys[0].device)
        for key in keys:
            same &= key[1:] == key[:-1]
        first[1:] = ~same
    return first


def thin(px, py, p: Params, L: int, Ly: Optional[int] = None):
    """Hits sorted by (diagonal, px), the first of each (diagonal,
    px // min_hit_dist) bucket kept -> (px, py) in that order. ``L``:
    X's length; ``Ly``: Y's (default ``L``)."""
    Ly = L if Ly is None else Ly
    diag = px - py
    order = torch.argsort((diag + Ly) * (L + 1) + px)
    px, py, diag = px[order], py[order], diag[order]
    keep = _first_of_runs(diag, px // p.min_hit_dist)
    return px[keep], py[keep]


# ------------------------------------------------------------ extension

@dataclass
class Tasks:
    """One extension direction of many seeds: base t (0-based) read at
    x = x0 + step * t in ``xbuf`` (length L) and y = y0 + step * t in
    ``ybuf[ybase : ybase + Ly]``, where ``ybuf`` holds Y then revcomp(Y),
    each Ly = len(ybuf) // 2 long."""

    x0: torch.Tensor
    y0: torch.Tensor
    step: torch.Tensor
    ybase: torch.Tensor

    @property
    def n(self) -> int:
        return self.x0.shape[0]

    def take(self, idx) -> "Tasks":
        return Tasks(self.x0[idx], self.y0[idx], self.step[idx],
                     self.ybase[idx])


def _read(buf, base, pos, L: int):
    ok = (pos >= 0) & (pos < L)
    return buf[base + pos.clamp(0, L - 1)].to(I32), ok


def extend_ungapped(t: Tasks, xbuf, ybuf, L: int, p: Params):
    """-> (ext, gain, idents, steps examined), int32/int64 per task."""
    E = p.max_extend
    if E % CHUNK:
        raise ValueError(f"max_extend {E} is not a multiple of {CHUNK}")
    dev = xbuf.device
    n = t.n
    Ly = ybuf.shape[0] // 2
    ext = torch.zeros(n, dtype=I32, device=dev)
    best = torch.zeros(n, dtype=I32, device=dev)
    best_id = torch.zeros(n, dtype=I32, device=dev)
    steps = torch.zeros(n, dtype=I64, device=dev)
    act = torch.arange(n, device=dev)
    s_c = torch.zeros(n, dtype=I32, device=dev)
    rm_c = torch.zeros(n, dtype=I32, device=dev)
    id_c = torch.zeros(n, dtype=I32, device=dev)
    u = torch.arange(CHUNK, device=dev)
    for c in range(E // CHUNK):
        if act.numel() == 0:
            break
        g = (c * CHUNK + u)[None, :] * t.step[act][:, None]
        xa, xok = _read(xbuf, 0, t.x0[act][:, None] + g, L)
        ya, yok = _read(ybuf, t.ybase[act][:, None], t.y0[act][:, None] + g, Ly)
        ok = xok & yok
        eq = ok & (xa == ya) & (xa < 4)
        s = s_c[:, None] + torch.cumsum(
            torch.where(eq, p.match, p.mismatch).to(I32), 1, dtype=I32)
        rm = torch.maximum(rm_c[:, None],
                           torch.cummax(s.clamp(min=0), 1).values)
        stop = ~ok | (s <= rm - p.x_drop)
        any_stop = stop.any(1)
        first = torch.argmax(stop.to(I32), 1)
        tl = torch.where(any_stop, first, CHUNK)
        steps[act] += torch.where(any_stop, first + 1, CHUNK)
        ids = id_c[:, None] + torch.cumsum(eq.to(I32), 1, dtype=I32)
        sm = torch.where(u[None, :] < tl[:, None], s, NEG)
        bi = torch.argmax(sm, 1, keepdim=True)            # first argmax
        bw = sm.gather(1, bi)[:, 0]
        better = bw > best[act]                            # ties keep earlier
        up = act[better]
        best[up] = bw[better]
        ext[up] = (c * CHUNK + bi[better, 0] + 1).to(I32)
        best_id[up] = ids.gather(1, bi)[better, 0]
        go = ~any_stop
        act = act[go]
        s_c, rm_c, id_c = s[go, -1], rm[go, -1], ids[go, -1]
    return ext, best, best_id, steps


def extend_banded(t: Tasks, xbuf, ybuf, L: int, p: Params):
    """Banded Gotoh x-drop -> (ext_x, ext_y, gain, idents, rows run)."""
    E, b = p.max_extend, p.band
    W = 2 * b + 1
    lanes = 1 << max(W - 1, 1).bit_length()       # a F key's lane field
    op, ex, xd = p.gap_open, p.gap_extend, p.x_drop
    dev = xbuf.device
    n = t.n
    Ly = ybuf.shape[0] // 2
    out_ei = torch.zeros(n, dtype=I32, device=dev)
    out_ej = torch.zeros(n, dtype=I32, device=dev)
    out_g = torch.zeros(n, dtype=I32, device=dev)
    out_id = torch.zeros(n, dtype=I32, device=dev)
    rows = torch.zeros(n, dtype=I64, device=dev)
    if n == 0:
        return out_ei, out_ej, out_g, out_id, rows
    o = torch.arange(W, device=dev)
    negs = lambda m: torch.full((m, W), NEG, dtype=I32, device=dev)

    # row 0: cell (0, 0) = 0; (0, j) = -(open + j * ext) where y[0..j) exist
    j0 = (o - b).clamp(min=0)
    yend = t.y0[:, None] + t.step[:, None] * (j0[None, :] - 1).clamp(min=0)
    y_in = lambda pos: (pos >= 0) & (pos < Ly)
    ok0 = (o[None, :] > b) & (j0[None, :] <= E) & y_in(t.y0)[:, None] & y_in(yend)
    H = torch.where(ok0, -(op + j0 * ex).to(I32), NEG).to(I32)
    H[:, b] = 0
    H = torch.where(H < -xd, NEG, H)
    Eg = negs(n)
    IH = torch.zeros(n, W, dtype=I32, device=dev)
    IE = torch.zeros_like(IH)
    best = torch.zeros(n, dtype=I32, device=dev)
    bei = torch.zeros_like(best)
    bej = torch.zeros_like(best)
    bid = torch.zeros_like(best)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    tk = t
    nrows = torch.zeros(n, dtype=I64, device=dev)
    m = n

    def flush():
        out_ei[live], out_ej[live], out_g[live], out_id[live] = bei, bej, best, bid
        rows[live] = nrows

    for i in range(1, E + 1):
        if (i - 1) % COMPACT == 0 and i > 1:
            flush()
            keep = torch.nonzero(alive)[:, 0]
            if keep.numel() == 0:
                break
            if keep.numel() < m:
                live, tk = live[keep], tk.take(keep)
                H, Eg, IH, IE = H[keep], Eg[keep], IH[keep], IE[keep]
                best, bei, bej, bid = best[keep], bei[keep], bej[keep], bid[keep]
                nrows, alive = nrows[keep], alive[keep]
                m = keep.numel()
        nrows += alive
        # donors: diagonal at lane o, vertical at o + 1
        Hu = torch.cat([H[:, 1:], negs(m)[:, :1]], 1)
        IHu = torch.cat([IH[:, 1:], IH[:, :1] * 0], 1)
        Eu = torch.cat([Eg[:, 1:], negs(m)[:, :1]], 1)
        IEu = torch.cat([IE[:, 1:], IE[:, :1] * 0], 1)
        j = i - b + o
        j_ok = (j >= 1) & (j <= E)
        jc = (j - 1).clamp(0, E - 1)
        yc, y_ok = _read(ybuf, tk.ybase[:, None],
                         tk.y0[:, None] + tk.step[:, None] * jc[None, :], Ly)
        yok = y_ok & j_ok[None, :]
        xc, xok = _read(xbuf, 0, tk.x0 + tk.step * (i - 1), L)
        xc, xok = xc[:, None], xok[:, None]
        match = (yc == xc) & (yc < 4) & (xc < 4) & yok & xok
        sub = torch.where(match, p.match, p.mismatch).to(I32)
        M = torch.where((H > NEG) & xok & yok, H + sub, NEG)
        IM = IH + match.to(I32)
        E1 = torch.where((Hu > NEG) & xok, Hu - op - ex, NEG)
        E2 = torch.where((Eu > NEG) & xok, Eu - ex, NEG)
        En = torch.maximum(E1, E2)
        IEn = torch.where(E1 >= E2, IHu, IEu)
        ME = torch.maximum(M, En)
        IME = torch.where(M >= En, IM, IEn)
        # F(o) = max over donors o' < o of ME(o') - open - ext * (o - o'):
        # an exclusive running max of ME + ext * o' along the row, whose
        # key carries the donor lane (ties: the later donor, as the
        # oracle's scan)
        A = torch.where(ME > NEG, (ME + ex * o).to(I64), NEG)
        key = torch.cat([torch.full((m, 1), NEG * lanes, dtype=I64,
                                    device=dev), (A * lanes + o)[:, :-1]], 1)
        cm = torch.cummax(key, 1).values
        amax = torch.div(cm, lanes, rounding_mode="floor")
        donor = (cm - amax * lanes).clamp(max=W - 1)
        F = torch.where((amax > NEG) & yok, (amax - op - ex * o).to(I32), NEG)
        IF = IME.gather(1, donor)
        Hn = torch.maximum(ME, F)
        IHn = torch.where(ME >= F, IME, IF)
        Hn = torch.where(alive[:, None], Hn, NEG)
        ob = torch.argmax(Hn, 1, keepdim=True)            # first argmax
        g = Hn.gather(1, ob)[:, 0]
        jb = (i - b + ob[:, 0]).to(I32)
        idb = IHn.gather(1, ob)[:, 0]
        better = (g > best) | ((g == best) & (i + jb < bei + bej))
        bei = torch.where(better, i, bei)
        bej = torch.where(better, jb, bej)
        bid = torch.where(better, idb, bid)
        best = torch.where(better, g, best)
        prune = Hn < (best - xd)[:, None]
        Hn = torch.where(prune, NEG, Hn)
        En = torch.where(prune, NEG, En)
        alive = alive & (Hn > NEG).any(1)
        H, Eg, IH, IE = Hn, En, IHn, IEn
    flush()
    return out_ei, out_ej, out_g, out_id, rows


def _extend(t: Tasks, xbuf, ybuf, L: int, p: Params):
    """-> (ext_x, ext_y, gain, idents, work) per task; work is rows run
    (banded) or steps examined (ungapped). Tasks run in blocks of at most
    TASK_BLOCK: each task's extension is its own, so the blocks bound the
    memory of a genome-scale batch and change no result."""
    if t.n > TASK_BLOCK:
        parts = [_extend(t.take(slice(i, i + TASK_BLOCK)), xbuf, ybuf, L, p)
                 for i in range(0, t.n, TASK_BLOCK)]
        return tuple(torch.cat(c) for c in zip(*parts))
    if p.extend_mode == "banded":
        return extend_banded(t, xbuf, ybuf, L, p)
    ext, gain, idn, steps = extend_ungapped(t, xbuf, ybuf, L, p)
    return ext, ext, gain, idn, steps


def _both_directions(px, py, ybase, xbuf, ybuf, L: int, p: Params):
    """Right and left extensions of seeds -> fragments (comparison space),
    and the work of each direction summed over the seeds."""
    n = px.shape[0]
    one = torch.ones(n, dtype=I64, device=px.device)
    t = Tasks(torch.cat([px + p.k, px - 1]), torch.cat([py + p.k, py - 1]),
              torch.cat([one, -one]), torch.cat([ybase, ybase]))
    ei, ej, g, idn, work = _extend(t, xbuf, ybuf, L, p)
    rei, lei = ei[:n].to(I64), ei[n:].to(I64)
    rej, lej = ej[:n].to(I64), ej[n:].to(I64)
    frag = {"xStart": px - lei, "yStart": py - lej,
            "xEnd": px + p.k - 1 + rei, "yEnd": py + p.k - 1 + rej,
            "score": (p.k * p.match + g[:n] + g[n:]).to(I64),
            "idents": (p.k + idn[:n] + idn[n:]).to(I64)}
    frag["length"] = frag["xEnd"] - frag["xStart"] + 1
    return frag, int(work.sum()), 2 * n


def extend_gated(seeds, xbuf, ybuf, L: int, p: Params):
    """Seeds of every strand, each (px, py, strand) sorted by (diagonal,
    px) -> (fragments, work, seed-directions extended). Anchors of all
    strands extend in one batch, then the survivors in another."""
    px = torch.cat([s[0] for s in seeds])
    py = torch.cat([s[1] for s in seeds])
    strand = torch.cat([torch.full_like(s[0], s[2]) for s in seeds])
    ybase = strand * (ybuf.shape[0] // 2)
    anchor = torch.cat([_first_of_runs(s[0] - s[1], s[0] // p.gate_stride)
                        if p.gate_stride > 0 else
                        torch.ones_like(s[0], dtype=torch.bool)
                        for s in seeds])
    ia = torch.nonzero(anchor)[:, 0]
    fa, work_a, dirs_a = _both_directions(px[ia], py[ia], ybase[ia], xbuf,
                                          ybuf, L, p)
    # each seed's bucket anchor: the last anchor at or before it (seeds of
    # one strand are contiguous and start with an anchor)
    ordinal = torch.cumsum(anchor.to(I64), 0) - 1
    covered = (~anchor & (fa["xStart"][ordinal] <= px)
               & (fa["xEnd"][ordinal] >= px + p.k - 1))
    isv = torch.nonzero(~anchor & ~covered)[:, 0]
    fs, work_s, dirs_s = _both_directions(px[isv], py[isv], ybase[isv], xbuf,
                                          ybuf, L, p)
    frag = {f: torch.cat([fa[f], fs[f]]) for f in fa}
    frag["strand"] = torch.cat([strand[ia], strand[isv]])
    return frag, work_a + work_s, dirs_a + dirs_s


# ---------------------------------------------------------------- merge

def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Indices sorting by keys[0], then keys[1], ... (all ascending)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def merge_accept(frag: Dict[str, torch.Tensor], p: Params, L: int):
    """Per-(strand, diagonal) merge, acceptance, original y coordinates and
    the canonical order; ``L`` is Y's length."""
    n = frag["xStart"].shape[0]
    if n == 0:
        return frag
    diag = frag["xStart"] - frag["yStart"]
    order = _lexsort(frag["strand"], diag, frag["xStart"], frag["yStart"])
    f = {k: v[order] for k, v in frag.items()}
    diag = diag[order]
    new_group = _first_of_runs(f["strand"], diag)
    gid = torch.cumsum(new_group.to(I64), 0)
    big = 1 << 33
    run_max = torch.cummax(gid * big + f["xEnd"], 0).values
    prev = torch.cat([run_max[:1] * 0, run_max[:-1]]) - gid * big
    new_run = new_group | (f["xStart"] > prev)
    run = torch.cumsum(new_run.to(I64), 0)
    # the winner of each run: highest score, then longest, then leftmost x,
    # then leftmost y; exact ties of that key go to the smallest (xEnd,
    # yEnd, idents), a total order as the determinism contract asks (the
    # numpy oracle keeps the first in seed order instead)
    win = _lexsort(run, -f["score"], -f["length"], f["xStart"], f["yStart"],
                   f["xEnd"], f["yEnd"], f["idents"])
    keep = win[_first_of_runs(run[win])]
    f = {k: v[keep] for k, v in f.items()}
    pct = int(round(p.min_identity * 100))
    ok = (f["length"] >= p.min_len) & (f["idents"] * 100 >= pct * f["length"])
    f = {k: v[ok] for k, v in f.items()}
    r = f["strand"] == 1
    f["yStart"] = torch.where(r, L - 1 - f["yStart"], f["yStart"])
    f["yEnd"] = torch.where(r, L - 1 - f["yEnd"], f["yEnd"])
    order = _lexsort(f["strand"], f["xStart"], f["yStart"], f["xEnd"],
                     f["yEnd"])
    return {k: v[order] for k, v in f.items()}


# ------------------------------------------------------------- families

def families(frag: Dict[str, torch.Tensor], p: Params, self_cmp: bool):
    """Family label per fragment (canonical order): the smallest index of
    its connected component."""
    n = frag["xStart"].shape[0]
    dev = frag["xStart"].device
    if n == 0:
        return torch.zeros(0, dtype=I64, device=dev)
    idx = torch.arange(n, device=dev)
    ylo = torch.minimum(frag["yStart"], frag["yEnd"])
    yhi = torch.maximum(frag["yStart"], frag["yEnd"])
    space = torch.cat([torch.zeros_like(idx), torch.zeros_like(idx)
                       if self_cmp else torch.ones_like(idx)])
    start = torch.cat([frag["xStart"], ylo])
    end = torch.cat([frag["xEnd"], yhi])
    fid = torch.cat([idx, idx])
    order = _lexsort(space, start)
    space, start, end, fid = space[order], start[order], end[order], fid[order]
    # an interval links to every later one of its space that starts within
    # proximity of its end
    big = int(max(int(end.max()), int(start.max())) + p.proximity + 2)
    key = space * big + start
    reach = torch.searchsorted(key, space * big + end + p.proximity,
                               right=True)
    m = key.shape[0]
    cnt = (reach - torch.arange(1, m + 1, device=dev)).clamp(min=0)
    a, off = _expand(cnt)
    ea, eb = fid[a], fid[a + 1 + off]
    la, lb = frag["length"][ea], frag["length"][eb]
    pct = int(round(p.len_ratio * 100))
    ok = (ea != eb) & (torch.minimum(la, lb) * 100 >= pct * torch.maximum(la, lb))
    ea, eb = ea[ok], eb[ok]
    lab = idx.clone()
    while True:
        m2 = torch.minimum(lab[ea], lab[eb])
        new = lab.scatter_reduce(0, ea, m2, "amin").scatter_reduce(
            0, eb, m2, "amin")
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


# ------------------------------------------------------------ the whole

def revcomp(codes: torch.Tensor) -> torch.Tensor:
    return torch.where(codes < 4, 3 - codes, codes).flip(0)


def compare(codes: np.ndarray, p: Params, device="cpu",
            max_extend: Optional[int] = None,
            codes_y: Optional[np.ndarray] = None):
    """Comparison of ``codes`` with itself, or with ``codes_y`` -> (the
    canonical fragment table with its "group" column, as int32 numpy
    arrays; {"work": rows or steps the extensions need, "extended":
    seed-directions extended}). ``max_extend`` overrides the
    configuration's cap (the control)."""
    if max_extend is not None:
        p = Params(**{**p.__dict__, "max_extend": max_extend})
    self_cmp = codes_y is None
    cx = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device)
    cy = cx if self_cmp else torch.from_numpy(
        np.ascontiguousarray(codes_y, np.uint8)).to(device)
    L, Ly = cx.shape[0], cy.shape[0]
    if min(L, Ly) < p.k:
        return ({f: np.zeros(0, np.int32) for f in FIELDS + ("group",)},
                {"work": 0, "extended": 0})
    cr = revcomp(cy)
    km, pos = kmer_index(cx, p.k)
    seeds = []
    if "f" in p.strands:
        hits = (self_hits_f(km, pos, p.max_occ) if self_cmp else
                cross_hits(km, pos, *kmer_index(cy, p.k), p.max_occ))
        seeds.append(thin(*hits, p, L, Ly) + (0,))
        del hits
    if "r" in p.strands:
        km_r, pos_r = kmer_index(cr, p.k)
        hits = (self_hits_r(km, pos, km_r, pos_r, p.max_occ, L, p.k)
                if self_cmp else cross_hits(km, pos, km_r, pos_r, p.max_occ))
        seeds.append(thin(*hits, p, L, Ly) + (1,))
        del km_r, pos_r, hits
    del km, pos
    ybuf = torch.cat([cy, cr])
    frag, work, extended = extend_gated(seeds, cx, ybuf, L, p)
    frag = merge_accept(frag, p, Ly)
    frag["group"] = families(frag, p, self_cmp)
    return ({f: frag[f].cpu().numpy().astype(np.int32)
             for f in FIELDS + ("group",)},
            {"work": work, "extended": extended})
