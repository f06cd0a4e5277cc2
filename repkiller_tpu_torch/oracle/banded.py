"""Banded affine-gap (Gotoh) seed extension — numpy oracle; the port's copy
of repkiller_tpu/oracle/banded.py.

BASELINE.json north star: "seed hits are chained by diagonal and extended
with a banded affine-gap DP kernel". The reference's extension family is
ungapped (SURVEY.md §2.2), so this stage has no C++ counterpart to imitate;
the semantics are DEFINED here and the device/Pallas implementations must
match this oracle bit-identically (SURVEY.md §4 determinism rules).

Spec (one direction; left extension runs the same DP on reversed suffixes):

  DP over rows i = 0..E (x bases consumed) and cols j (y bases consumed)
  restricted to the band |i - j| <= band. An affine gap of length g costs
  gap_open + g * gap_extend. Substitution scores cfg.match on equal
  non-N codes, cfg.mismatch otherwise. Out-of-band / out-of-sequence
  cells are NEG_INF.

    M(i,j) = H(i-1,j-1) + sub(x[i-1], y[j-1])
    E(i,j) = max(H(i-1,j) - open, E(i-1,j)) - ext     # gap in y (x consumed)
    F(i,j) = max(H(i,j-1) - open, F(i,j-1)) - ext     # gap in x (y consumed)
    H(i,j) = max(M, E, F);  H(0,0) = 0

  Because open >= 0 and H >= F, F simplifies to the within-row scan
  F(i,j) = max(ME(i,j-1) - open, F(i,j-1)) - ext with ME = max(M, E),
  so rows depend only on the previous row (the wavefront the TPU kernel
  uses). The band is stored as W = 2*band+1 lanes, lane o = column
  j = i - band + o; donors: diagonal at o, vertical at o+1, horizontal at
  o-1 in the current row.

  X-drop: after each row, best = max(best, row max); cells with
  H < best - x_drop become NEG_INF in ALL states (they cannot seed later
  maxima); the scan stops when a whole row is NEG_INF or i == E.

  Endpoint: the cell maximising H; ties broken by smaller i+j, then
  smaller i. Candidate (0,0) with H=0 is always present ("no extension").

  Identities: number of matched bases on the path realising H, carried
  through the DP alongside scores; on score ties the branch priority is
  M > E > F, and within the F row-scan an earlier donor column wins ties.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import Config

NEG_INF = np.int32(-(1 << 30))


def _extend_direction(
    sx: np.ndarray, sy: np.ndarray, xvalid: np.ndarray, yvalid: np.ndarray, cfg: Config
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Banded Gotoh x-drop extension, vectorised over seeds.

    sx, sy: uint8[n, E] code windows (consumed left-to-right from the seed
    edge; callers pass reversed windows for left extension).
    xvalid, yvalid: bool[n, E] — base exists (in sequence bounds).

    Returns (ext_x, ext_y, gain, idents) int32[n].
    """
    n, E = sx.shape
    b = cfg.band
    W = 2 * b + 1
    open_, ext = np.int32(cfg.gap_open), np.int32(cfg.gap_extend)
    xdrop = np.int32(cfg.x_drop)
    rng_n = np.arange(n)

    # ---- row 0 ----
    H = np.full((n, W), NEG_INF, np.int32)
    Eg = np.full((n, W), NEG_INF, np.int32)
    IH = np.zeros((n, W), np.int32)
    IE = np.zeros((n, W), np.int32)
    H[:, b] = 0  # cell (0, 0)
    for o in range(b + 1, W):
        j = o - b
        ok = yvalid[:, :j].all(axis=1) if j <= E else np.zeros(n, bool)
        H[:, o] = np.where(ok, -(open_ + np.int32(j) * ext), NEG_INF)

    best = np.zeros(n, np.int32)       # max H anywhere == endpoint gain
    best_ei = np.zeros(n, np.int32)
    best_ej = np.zeros(n, np.int32)
    best_id = np.zeros(n, np.int32)
    # row-0 cells are all <= 0, never beat the (0,0) candidate; prune them
    H = np.where(H < (best - xdrop)[:, None], NEG_INF, H)

    alive = np.ones(n, bool)
    for i in range(1, E + 1):
        if not alive.any():
            break
        # donors from previous row: diagonal at o, vertical at o+1
        Hd, IHd = H, IH
        Hu = np.full((n, W), NEG_INF, np.int32)
        Hu[:, :-1] = H[:, 1:]
        IHu = np.zeros((n, W), np.int32)
        IHu[:, :-1] = IH[:, 1:]
        Eu = np.full((n, W), NEG_INF, np.int32)
        Eu[:, :-1] = Eg[:, 1:]
        IEu = np.zeros((n, W), np.int32)
        IEu[:, :-1] = IE[:, 1:]

        # cell (i, j = i-b+o) consumes x[i-1] and (for M/F) y[j-1]
        o_idx = np.arange(W, dtype=np.int32)[None, :]
        j_idx = np.int32(i - b) + o_idx                    # (1, W)
        j_ok = (j_idx >= 1) & (j_idx <= E)
        jc = np.broadcast_to(np.clip(j_idx - 1, 0, E - 1), (n, W))
        ychar = np.take_along_axis(sy, jc, axis=1)
        yok = np.take_along_axis(yvalid, jc, axis=1) & j_ok
        xchar = sx[:, i - 1 : i]
        xok = xvalid[:, i - 1 : i]
        is_match = (ychar == xchar) & (ychar < 4) & (xchar < 4) & yok & xok
        sub = np.where(is_match, np.int32(cfg.match), np.int32(cfg.mismatch))

        M = np.where((Hd > NEG_INF) & xok & yok, Hd + sub, NEG_INF)
        IM = IHd + is_match.astype(np.int32)

        Ec1 = np.where((Hu > NEG_INF) & xok, Hu - open_ - ext, NEG_INF)
        Ec2 = np.where((Eu > NEG_INF) & xok, Eu - ext, NEG_INF)
        Enew = np.maximum(Ec1, Ec2)
        IEnew = np.where(Ec1 >= Ec2, IHu, IEu)

        ME = np.maximum(M, Enew)
        IME = np.where(M >= Enew, IM, IEnew)

        # F: within-row scan over o (j ascending); donor (i, j-1) is o-1
        Fnew = np.full((n, W), NEG_INF, np.int32)
        IFnew = np.zeros((n, W), np.int32)
        fcur = np.full(n, NEG_INF, np.int32)
        ficur = np.zeros(n, np.int32)
        for o in range(1, W):
            c1 = np.where(ME[:, o - 1] > NEG_INF, ME[:, o - 1] - open_ - ext, NEG_INF)
            c2 = np.where(fcur > NEG_INF, fcur - ext, NEG_INF)
            ficur = np.where(c1 >= c2, IME[:, o - 1], ficur)
            fcur = np.maximum(c1, c2)
            Fnew[:, o] = np.where(yok[:, o], fcur, NEG_INF)
            IFnew[:, o] = ficur

        Hn = np.maximum(ME, Fnew)
        IHn = np.where(ME >= Fnew, IME, IFnew)
        Hn = np.where(alive[:, None], Hn, NEG_INF)

        # endpoint candidate: row max, tie -> smallest j (first argmax)
        o_best = np.argmax(Hn, axis=1).astype(np.int32)
        g = Hn[rng_n, o_best]
        j_best = np.int32(i - b) + o_best
        id_best = IHn[rng_n, o_best]
        cur_d = best_ei + best_ej
        better = (g > best) | ((g == best) & (np.int32(i) + j_best < cur_d))
        best_ei = np.where(better, np.int32(i), best_ei)
        best_ej = np.where(better, j_best, best_ej)
        best_id = np.where(better, id_best, best_id)
        best = np.where(better, g, best)

        # x-drop prune (all states), then liveness
        prune = Hn < (best - xdrop)[:, None]
        Hn = np.where(prune, NEG_INF, Hn)
        Enew = np.where(prune, NEG_INF, Enew)
        alive = alive & (Hn > NEG_INF).any(axis=1)

        H, Eg, IH, IE = Hn, Enew, IHn, IEnew

    return best_ei, best_ej, best, best_id


def _gather_windows(codes: np.ndarray, start: np.ndarray, step: int, E: int):
    """codes[start + step*t] for t in [0, E) with in-bounds validity mask."""
    t = np.arange(E, dtype=np.int64)[None, :]
    pos = start.astype(np.int64)[:, None] + np.int64(step) * t
    ok = (pos >= 0) & (pos < codes.shape[0])
    return codes[np.clip(pos, 0, codes.shape[0] - 1)], ok


def extend_banded(
    px: np.ndarray, py: np.ndarray, cx: np.ndarray, cy: np.ndarray, cfg: Config
) -> Dict[str, np.ndarray]:
    """Banded affine-gap extension of seeds (px, py); returns fragment dict
    in the layout of oracle.pipeline.FRAG_FIELDS (comparison-space coords).

    Unlike the ungapped extender, xEnd-xStart and yEnd-yStart may differ
    (gaps); `length` remains the x-extent per the fragment model.
    """
    from .pipeline import FRAG_FIELDS  # late import to avoid a cycle

    n = px.shape[0]
    if n == 0:
        return {f: np.zeros(0, np.int32) for f in FRAG_FIELDS}
    E = cfg.max_extend
    k = cfg.k

    # right: x suffix from px+k, y suffix from py+k
    sxr, xvr = _gather_windows(cx, px + k, +1, E)
    syr, yvr = _gather_windows(cy, py + k, +1, E)
    rei, rej, rgain, rid = _extend_direction(sxr, syr, xvr, yvr, cfg)

    # left: reversed prefixes ending at px-1 / py-1
    sxl, xvl = _gather_windows(cx, px - 1, -1, E)
    syl, yvl = _gather_windows(cy, py - 1, -1, E)
    lei, lej, lgain, lid = _extend_direction(sxl, syl, xvl, yvl, cfg)

    seed_score = np.int32(k * cfg.match)
    frag = {
        "xStart": (px - lei).astype(np.int32),
        "yStart": (py - lej).astype(np.int32),
        "xEnd": (px + k - 1 + rei).astype(np.int32),
        "yEnd": (py + k - 1 + rej).astype(np.int32),
        "strand": np.zeros(n, np.int32),
        "score": (seed_score + lgain + rgain).astype(np.int32),
        "idents": (k + lid + rid).astype(np.int32),
    }
    frag["length"] = (frag["xEnd"] - frag["xStart"] + 1).astype(np.int32)
    return frag
