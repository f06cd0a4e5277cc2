"""Ungapped extension around kernel K2 (counterpart of
repkiller_tpu/extend/ungapped_pallas.py ``extend_ungapped_pallas``).

``_direction`` picks the implementation from the tensors' device: CUDA
tensors launch the hand-written kernel (extend/_cuda.py), CPU tensors run
its plain version (extend/ungapped.py). There is no fallback between the
two: a failed build or launch raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _cuda
from .ungapped import direction_plain


def _direction(px, py, seed_valid, cx, cy, base_off: int, step: int,
               match: int, mismatch: int, x_drop: int, max_extend: int,
               n_live=None):
    """One direction for all seeds -> (ext, gain, idents) int32[n]. Live
    seeds are dense at the front: slots at or past ``n_live`` give zeros."""
    if n_live is None:
        n_live = px.shape[0]
    args = (px, py, seed_valid, cx, cy, base_off, step, match, mismatch,
            x_drop, max_extend, n_live)
    if px.device.type == "cuda":
        return _cuda.ungapped_xdrop(*args)
    if px.device.type == "cpu":
        return direction_plain(*args)
    raise ValueError(f"no ungapped extension for device {px.device}")


def extend_ungapped(px, py, seed_valid, cx, cy, k: int, match: int,
                    mismatch: int, x_drop: int, max_extend: int, n_live=None
                    ) -> Dict[str, torch.Tensor]:
    """Extend each seed to the right (from px + k) and to the left (from
    px - 1) -> fragment dict in comparison coordinates, strand unset;
    invalid slots carry zeroed rows."""
    common = (match, mismatch, x_drop, max_extend)
    rext, rgain, rid = _direction(px, py, seed_valid, cx, cy, k, +1, *common,
                                  n_live=n_live)
    lext, lgain, lid = _direction(px, py, seed_valid, cx, cy, -1, -1, *common,
                                  n_live=n_live)
    frag = {
        "xStart": px - lext,
        "yStart": py - lext,
        "xEnd": px + (k - 1) + rext,
        "yEnd": py + (k - 1) + rext,
        "strand": torch.zeros_like(px),
        "score": k * match + lgain + rgain,
        "idents": k + lid + rid,
    }
    frag["length"] = frag["xEnd"] - frag["xStart"] + 1
    return {f: torch.where(seed_valid, v, 0) for f, v in frag.items()}
