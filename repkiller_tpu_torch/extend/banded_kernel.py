"""Two-phase banded extension around kernel K1 (counterpart of
repkiller_tpu/extend/banded_pallas.py; its docstrings give the full
arguments for the phase structure and the fused coverage gating).

``_direction`` picks the implementation from the tensors' device: CUDA
tensors launch the hand-written kernel (extend/_cuda.py), CPU tensors run
its plain version (extend/banded.py). There is no fallback between the two:
a failed build or launch raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.scan import partition_live
from . import _cuda
from .banded import direction_plain


def _direction(px, py, seed_valid, cx, cy, base_off: int, step: int,
               match: int, mismatch: int, x_drop: int, max_extend: int,
               band: int, gap_open: int, gap_extend: int, n_live=None,
               jcap=None):
    """One direction for all seeds -> (ei, ej, gain, idents, alive) int32[n].
    Live seeds are dense at the front: slots at or past ``n_live`` give
    zeros. ``jcap`` defaults to ``max_extend`` (a full-depth pass)."""
    if n_live is None:
        n_live = px.shape[0]
    if jcap is None:
        jcap = max_extend
    args = (px, py, seed_valid, cx, cy, base_off, step, match, mismatch,
            x_drop, max_extend, band, gap_open, gap_extend, jcap, n_live)
    if px.device.type == "cuda":
        return _cuda.banded_gotoh(*args)
    if px.device.type == "cpu":
        return direction_plain(*args)
    raise ValueError(f"no banded extension for device {px.device}")


def _compact_rerun(px, py, need, cx, cy, base_off: int, step: int, common,
                   cap_rows: int, tail):
    """Re-run one direction at row cap ``cap_rows`` for the ``need`` seeds,
    compacted to the front; results come back in slot order (slots outside
    ``need`` carry values the callers discard with ``where(need, ...)``)."""
    order, dest, n2 = partition_live(need)
    ei, ej, g, idn, _ = _direction(px[order], py[order], need[order], cx, cy,
                                   base_off, step, *common, cap_rows, *tail,
                                   n_live=n2)
    res = torch.stack([ei, ej, g, idn])[:, dest]
    return tuple(res.unbind(0))


def _frag(px, py, k: int, match: int, valid, right, left) -> Dict[str, torch.Tensor]:
    rei, rej, rg, rid = right
    lei, lej, lg, lid = left
    frag = {
        "xStart": px - lei,
        "yStart": py - lej,
        "xEnd": px + (k - 1) + rei,
        "yEnd": py + (k - 1) + rej,
        "strand": torch.zeros_like(px),
        "score": k * match + lg + rg,
        "idents": k + lid + rid,
    }
    frag["length"] = frag["xEnd"] - frag["xStart"] + 1
    return {f: torch.where(valid, v, 0) for f, v in frag.items()}


def extend_banded_gated(
    px, py, seed_valid, anchor, cx, cy, k: int, match: int, mismatch: int,
    x_drop: int, max_extend: int, band: int, gap_open: int, gap_extend: int,
    n_live=None, phase1_rows: int = 192,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Coverage gating fused into the two-phase extension -> (frag dict,
    valid mask); equal to the oracle's gated extension.

    1. phase 1 (row cap ``phase1_rows``, jcap = phase1_rows + band) runs
       over all seeds in slot order;
    2. non-anchors whose k-mer window lies inside their bucket anchor's
       phase-1 x-extent are gated at once (phase-1 extents are lower bounds
       of the final ones);
    3. one full-depth compacted pass per direction extends the seeds still
       alive at the row cap that gating has not excluded;
    4. the exact coverage test against the anchors' final extents zeroes
       the non-anchors that turn out covered."""
    n = px.shape[0]
    common = (match, mismatch, x_drop)
    tail = (band, gap_open, gap_extend)
    idx = torch.arange(n, dtype=torch.int32, device=px.device)
    # slot of my bucket's anchor: the last anchor at or before me
    anc_slot = torch.cummax(torch.where(anchor, idx, 0), 0).values
    km1 = k - 1

    def covered_by_anchor(lei, rei):
        ex = torch.stack([px - lei, px + km1 + rei], dim=1)[anc_slot]
        return (seed_valid & ~anchor & (ex[:, 0] <= px)
                & (ex[:, 1] >= px + km1))

    if max_extend > phase1_rows + band:
        def phase1(base_off, step):
            ei, ej, g, idn, alive = _direction(
                px, py, seed_valid, cx, cy, base_off, step, *common,
                phase1_rows, *tail, n_live=n_live, jcap=phase1_rows + band)
            return (ei, ej, g, idn), seed_valid & (alive == 1)

        right1, r_alive = phase1(k, +1)
        left1, l_alive = phase1(-1, -1)
        maybe = seed_valid & ~covered_by_anchor(left1[0], right1[0])
        need_r = maybe & r_alive
        need_l = maybe & l_alive
        right2 = _compact_rerun(px, py, need_r, cx, cy, k, +1, common,
                                max_extend, tail)
        left2 = _compact_rerun(px, py, need_l, cx, cy, -1, -1, common,
                               max_extend, tail)
        right = tuple(torch.where(need_r, a, b) for a, b in zip(right2, right1))
        left = tuple(torch.where(need_l, a, b) for a, b in zip(left2, left1))
    else:
        # one pass reaches max_extend: extend everything, gate afterwards
        right = _direction(px, py, seed_valid, cx, cy, k, +1, *common,
                           max_extend, *tail, n_live=n_live)[:4]
        left = _direction(px, py, seed_valid, cx, cy, -1, -1, *common,
                          max_extend, *tail, n_live=n_live)[:4]

    valid_out = seed_valid & ~covered_by_anchor(left[0], right[0])
    return _frag(px, py, k, match, valid_out, right, left), valid_out


def extend_banded(
    px, py, seed_valid, cx, cy, k: int, match: int, mismatch: int,
    x_drop: int, max_extend: int, band: int, gap_open: int, gap_extend: int,
    n_live=None, phase1_rows: int = 192,
) -> Dict[str, torch.Tensor]:
    """Ungated banded extension of every seed (the reference's
    ``extend_banded_pallas``): the gated extension with every valid seed
    its own anchor, so nothing is gated."""
    return extend_banded_gated(
        px, py, seed_valid, seed_valid, cx, cy, k, match, mismatch, x_drop,
        max_extend, band, gap_open, gap_extend, n_live, phase1_rows)[0]
