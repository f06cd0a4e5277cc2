"""Diagonal hit thinning (counterpart of repkiller_tpu/seeds/filter.py):
sort hits by (diag, px), keep the first hit of every
(diag, px // min_hit_dist) bucket, compact the kept hits to the front."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.scan import INT32_MAX, partition_live


def filter_hits(hpx: torch.Tensor, hpy: torch.Tensor, hvalid: torch.Tensor,
                min_hit_dist: int, out_capacity: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (px, py, valid, n_kept); kept hits dense at the front in
    (diag, px) order, arrays trimmed to ``out_capacity``. ``n_kept`` is
    the true count: the caller raises when it exceeds ``out_capacity``.

    The (diagI, px) sort key packs into one int64: diagI + 2^31 < 2^32
    (invalid hits carry INT32_MAX) and 0 <= px < 2^31. (diag, px) is a
    total order over distinct hits; tied invalid rows are all zeros."""
    diagI = torch.where(hvalid, hpx - hpy, INT32_MAX)
    key = ((diagI.to(torch.int64) + (1 << 31)) << 31) | hpx.to(torch.int64)
    _, perm = torch.sort(key, stable=True)
    diag_s, px_s, py_s = diagI[perm], hpx[perm], hpy[perm]
    valid_s = diag_s != INT32_MAX
    bucket = px_s // min_hit_dist
    first = torch.ones_like(valid_s)
    first[1:] = (diag_s[1:] != diag_s[:-1]) | (bucket[1:] != bucket[:-1])
    keep = valid_s & first

    order, _, n_kept = partition_live(keep)
    if out_capacity is not None and out_capacity < order.shape[0]:
        order = order[:out_capacity]
    rows = torch.stack([px_s, py_s], dim=1)[order]
    valid_c = torch.arange(rows.shape[0], dtype=torch.int32,
                           device=hpx.device) < n_kept
    px_c = torch.where(valid_c, rows[:, 0], 0)
    py_c = torch.where(valid_c, rows[:, 1], 0)
    return px_c, py_c, valid_c, n_kept
