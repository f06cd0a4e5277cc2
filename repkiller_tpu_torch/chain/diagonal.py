"""Seed chaining by coverage gating (counterpart of
repkiller_tpu/chain/diagonal.py, whose docstring states the semantics):
the first seed of every (diagonal, px // gate_stride) bucket is an anchor
and always extends; a later seed of the bucket is dropped iff its k-mer
window lies inside its anchor's fragment x-extent.

The banded extension fuses gating into its two-phase structure
(extend/banded_kernel.extend_banded_gated). The ungapped extension takes
the generic path: extend the anchors, test coverage, extend the
survivors."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import Config
from ..extend import extend_dispatch
from ..extend.banded_kernel import extend_banded_gated
from ..utils.scan import partition_live


def gate_anchors(spx, spy, svalid, gate_stride: int) -> torch.Tensor:
    """Anchor mask over (diag, px)-sorted seeds: the first valid seed of
    each (diagonal, px // gate_stride) bucket."""
    diag = spx - spy
    bucket = spx // gate_stride
    prev_same = torch.zeros_like(svalid)
    prev_same[1:] = (diag[1:] == diag[:-1]) & (bucket[1:] == bucket[:-1])
    return svalid & ~prev_same


def extend_gated(spx, spy, svalid, cx, cy, cfg: Config, n_live=None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Extend (diag, px)-sorted seeds, live ones dense at the front, with
    coverage gating -> (frag dict, valid mask). Gated seeds come back
    invalid with zeroed rows. gate_stride == 0 extends every seed."""
    if cfg.gate_stride <= 0:
        return extend_dispatch(spx, spy, svalid, cx, cy, cfg, n_live=n_live), svalid
    anchor = gate_anchors(spx, spy, svalid, cfg.gate_stride)
    if cfg.extend_mode == "banded":
        return extend_banded_gated(
            spx, spy, svalid, anchor, cx, cy, k=cfg.k, match=cfg.match,
            mismatch=cfg.mismatch, x_drop=cfg.x_drop,
            max_extend=cfg.max_extend, band=cfg.band, gap_open=cfg.gap_open,
            gap_extend=cfg.gap_extend, n_live=n_live)

    # anchors to the front, in (diag, px) order: live seeds dense
    n = spx.shape[0]
    order_a, _, n_anchor = partition_live(anchor)
    fa = extend_dispatch(spx[order_a], spy[order_a], anchor[order_a], cx, cy,
                         cfg, n_live=n_anchor)
    # every seed's bucket anchor sits at compacted slot cumsum(anchor) - 1
    ordinal = (torch.cumsum(anchor.to(torch.int32), 0, dtype=torch.int32)
               - 1).clamp(0, max(n - 1, 0))
    covered = (svalid & ~anchor & (fa["xStart"][ordinal] <= spx)
               & (fa["xEnd"][ordinal] >= spx + (cfg.k - 1)))
    surv = svalid & ~anchor & ~covered

    order_s, inv_s, n_surv = partition_live(surv)
    fs = extend_dispatch(spx[order_s], spy[order_s], surv[order_s], cx, cy,
                         cfg, n_live=n_surv)
    frag = {f: torch.where(anchor, fa[f][ordinal],
                           torch.where(surv, fs[f][inv_s], 0)) for f in fa}
    return frag, anchor | surv
