"""Banded affine-gap (Gotoh) x-drop extension of one direction, in plain
torch ops: the reference version of kernel K1 (csrc/banded_gotoh.cu).

Semantics are those of repkiller_tpu/extend/banded_xla.py ``_direction``
(oracle/banded.py defines them), widened to the Pallas kernel's contract
(repkiller_tpu/extend/banded_pallas.py ``_make_kernel``/``_direction``):

- ``jcap`` caps the column (y-step) index: cells with j > jcap are out of
  band. Full passes use jcap == E; a phase-1 pass at row cap E1 uses
  jcap = E1 + band, which makes every cell of rows <= E1 identical to the
  full-depth run's, so death by row E1 is final.
- ``alive`` is 1 where a cell is still live after the last row (the seed
  needs a deeper pass), else 0.
- slots at or past ``n_live`` and seeds with ``valid`` false give zeros,
  ``alive`` included.
- row 0 is the Pallas kernel's: the cells right of centre need every
  y-step 1..j inside the sequence; jcap does not apply there.

State is (n, W) int32, band lane o holding column j = i - band + o; donors
are the diagonal at o and the vertical at o+1 of the previous row and the
horizontal at o-1 of the current row. The horizontal state is an
argmax-last max-plus prefix scan (Hillis-Steele, log2(W) steps), equal to
the oracle's sequential scan with its tie rules.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -(1 << 30)


def _down(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """result[:, o] = x[:, o-d]; the first d lanes get ``fill``."""
    return torch.cat([torch.full_like(x[:, :d], fill), x[:, :-d]], dim=1)


def direction_plain(px, py, valid, cx, cy, base_off: int, step: int,
                    match: int, mismatch: int, x_drop: int, E: int, band: int,
                    gap_open: int, gap_extend: int, jcap: int, n_live, *,
                    live_rows: bool = False) -> Tuple[torch.Tensor, ...]:
    """One direction for all seeds -> (ei, ej, gain, idents, alive) int32[n].

    The base consumed at x-step i is ``cx[px + base_off + step*(i-1)]``,
    the same for y with j (right: base_off=k, step=+1; left: base_off=-1,
    step=-1). ``n_live`` is an int or a 0-d tensor. ``live_rows`` appends
    a sixth output: int64[rows run], the number of seeds that enter each
    row with a live cell, whose sum is the seed-rows the work needs."""
    n = px.shape[0]
    m = min(n, int(n_live))
    if m < n:                  # slots past n_live are zeros: compute the prefix
        out = direction_plain(px[:m], py[:m], valid[:m], cx, cy, base_off, step,
                              match, mismatch, x_drop, E, band, gap_open,
                              gap_extend, jcap, m, live_rows=live_rows)
        padded = tuple(torch.cat([r, r.new_zeros(n - m)]) for r in out[:5])
        return padded + tuple(out[5:])
    dev = px.device
    b = band
    W = 2 * b + 1
    Lx, Ly = cx.shape[0], cy.shape[0]
    i32 = torch.int32
    o = torch.arange(W, dtype=i32, device=dev)[None, :]
    oext = o * gap_extend
    ybase = (py.to(torch.int64) + base_off)[:, None]
    xbase = px.to(torch.int64) + base_off

    def y_at(j):
        """(code, inside the sequence) of y-step j, shape (n, W)."""
        g = ybase + step * (j - 1).to(torch.int64)
        ok = (g >= 0) & (g < Ly) & valid[:, None]
        return cy[g.clamp(0, max(Ly - 1, 0))].to(i32), ok

    # row 0: H(0,0) = 0; H(0,j>0) = -(open + j*ext) while y-steps 1..j exist
    j0 = o - b
    _, yin0 = y_at(j0.expand(n, W))
    right = j0 > 0
    all_ok = torch.cumsum((right & ~yin0).to(i32), 1) == 0
    H = torch.where(j0 == 0, 0,
                    torch.where(right & all_ok, -(gap_open + j0 * gap_extend),
                                NEG_INF)).to(i32)
    H = torch.where(valid[:, None], H, NEG_INF)
    H = torch.where(H < -x_drop, NEG_INF, H)
    Eg = torch.full((n, W), NEG_INF, dtype=i32, device=dev)
    IH = torch.zeros((n, W), dtype=i32, device=dev)
    IE = torch.zeros((n, W), dtype=i32, device=dev)
    best = torch.zeros(n, dtype=i32, device=dev)
    bei = torch.zeros(n, dtype=i32, device=dev)
    bej = torch.zeros(n, dtype=i32, device=dev)
    bid = torch.zeros(n, dtype=i32, device=dev)
    neg_col = torch.full((n, 1), NEG_INF, dtype=i32, device=dev)
    zero_col = torch.zeros((n, 1), dtype=i32, device=dev)
    per_row = []

    for i in range(1, E + 1):
        live = (H > NEG_INF).any(dim=1)
        if live_rows:
            per_row.append(live.sum())
        if not bool(live.any()):
            break
        j = i - b + o
        ych, yin = y_at(j.expand(n, W))
        yok = yin & (j >= 1) & (j <= jcap)
        gx = xbase + step * (i - 1)
        xok = ((gx >= 0) & (gx < Lx) & valid)[:, None]
        xch = cx[gx.clamp(0, max(Lx - 1, 0))].to(i32)[:, None]
        is_match = (ych == xch) & (ych < 4) & yok & xok
        sub = torch.where(is_match, match, mismatch).to(i32)

        Hu = torch.cat([H[:, 1:], neg_col], dim=1)
        IHu = torch.cat([IH[:, 1:], zero_col], dim=1)
        Eu = torch.cat([Eg[:, 1:], neg_col], dim=1)
        IEu = torch.cat([IE[:, 1:], zero_col], dim=1)

        M = torch.where((H > NEG_INF) & xok & yok, H + sub, NEG_INF)
        IM = IH + is_match.to(i32)
        Ec1 = torch.where((Hu > NEG_INF) & xok, Hu - gap_open - gap_extend, NEG_INF)
        Ec2 = torch.where((Eu > NEG_INF) & xok, Eu - gap_extend, NEG_INF)
        Enew = torch.maximum(Ec1, Ec2)
        IEnew = torch.where(Ec1 >= Ec2, IHu, IEu)
        ME = torch.maximum(M, Enew)
        IME = torch.where(M >= Enew, IM, IEnew)

        # F(o) = max_{o'<o}(ME(o') - open - (o-o')*ext): argmax-last scan
        # of w = ME + o*ext, then shifted one lane (exclusive)
        w = torch.where(ME > NEG_INF, ME + oext, NEG_INF)
        wid = IME
        d = 1
        while d < W:
            w_sh = _down(w, d, NEG_INF)
            take = w_sh > w                  # an earlier donor wins only strictly
            wid = torch.where(take, _down(wid, d, 0), wid)
            w = torch.maximum(w, w_sh)
            d *= 2
        wmax_ex = _down(w, 1, NEG_INF)
        wid_ex = _down(wid, 1, 0)
        F = torch.where((wmax_ex > NEG_INF) & yok,
                        wmax_ex - gap_open - oext, NEG_INF)

        Hn = torch.maximum(ME, F)
        IHn = torch.where(ME >= F, IME, wid_ex)

        # endpoint: row max, first (smallest j) on ties; across rows higher
        # score, then smaller i+j, then the earlier row
        ob = torch.argmax(Hn, dim=1, keepdim=True)
        g = Hn.gather(1, ob)[:, 0]
        jb = (i - b + ob[:, 0]).to(i32)
        idb = IHn.gather(1, ob)[:, 0]
        better = (g > best) | ((g == best) & (i + jb < bei + bej))
        bei = torch.where(better, i, bei)
        bej = torch.where(better, jb, bej)
        bid = torch.where(better, idb, bid)
        best = torch.where(better, g, best)

        prune = Hn < (best - x_drop)[:, None]
        H = torch.where(prune, NEG_INF, Hn)
        Eg = torch.where(prune, NEG_INF, Enew)
        IH, IE = IHn, IEnew

    alive = (H > NEG_INF).any(dim=1).to(i32)
    if live_rows:
        counts = (torch.stack(per_row) if per_row
                  else torch.zeros(0, dtype=torch.int64, device=dev))
        return bei, bej, best, bid, alive, counts
    return bei, bej, best, bid, alive
