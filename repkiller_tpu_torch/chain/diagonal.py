"""Seed chaining by coverage gating (counterpart of
repkiller_tpu/chain/diagonal.py, whose docstring states the semantics):
the first seed of every (diagonal, px // gate_stride) bucket is an anchor
and always extends; a later seed of the bucket is dropped iff its k-mer
window lies inside its anchor's fragment x-extent."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repkiller_tpu.config import Config

from ..extend.banded_kernel import extend_banded_gated


def extend_gated(spx, spy, svalid, cx, cy, cfg: Config, n_live=None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Extend (diag, px)-sorted seeds, live ones dense at the front, with
    coverage gating -> (frag dict, valid mask). Gated seeds come back
    invalid with zeroed rows. gate_stride == 0 extends every seed."""
    if cfg.extend_mode != "banded":
        raise NotImplementedError(
            f"extend_mode={cfg.extend_mode!r}: the ungapped extension (kernel "
            "K2) is the next slice of the port, see ROADMAP.md")
    kw = dict(k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
              x_drop=cfg.x_drop, max_extend=cfg.max_extend, band=cfg.band,
              gap_open=cfg.gap_open, gap_extend=cfg.gap_extend, n_live=n_live)
    if cfg.gate_stride <= 0:
        anchor = svalid                # every seed its own anchor: no gating
    else:
        diag = spx - spy
        bucket = spx // cfg.gate_stride
        prev_same = torch.zeros_like(svalid)
        prev_same[1:] = (diag[1:] == diag[:-1]) & (bucket[1:] == bucket[:-1])
        anchor = svalid & ~prev_same
    return extend_banded_gated(spx, spy, svalid, anchor, cx, cy, **kw)
