"""Run bounds and static-capacity owner recovery (counterpart of
repkiller_tpu/seeds/join.py ``_run_bounds`` and ``owner_rows``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.scan import INT32_MAX


def owner_rows(counts: torch.Tensor, offs: torch.Tensor, capacity: int,
               vals: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Slot t -> (offs, *vals) of the contributing entry whose block
    [offs, offs+count) contains t, as (capacity, 1+len(vals)) int32 rows.

    Contributors (count > 0) are compacted to an offs-sorted prefix by one
    stable sort, their block starts are scattered into a capacity-sized
    array (block starts are unique; entries past capacity land in one
    spill slot that is never read) and a running max maps every slot to
    its owner."""
    n = counts.shape[0]
    dev = counts.device
    key = torch.where(counts > 0, offs, INT32_MAX)
    skey, perm = torch.sort(key, stable=True)
    m = min(capacity, n)
    perm = perm[:m]
    dense = [skey[:m]] + [v.to(torch.int32)[perm] for v in vals]
    ci = torch.arange(m, dtype=torch.int32, device=dev)
    bidx = torch.where(dense[0] < capacity, dense[0], capacity)
    owner = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    owner[bidx] = ci
    src = torch.cummax(owner[:capacity], 0).values
    return torch.stack(dense, dim=1)[src]


def _run_bounds(k_sorted: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-entry [run_start, run_end) of equal-value runs in a sorted
    array: two O(n) scans."""
    n = k_sorted.shape[0]
    dev = k_sorted.device
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)
    edge = k_sorted[1:] != k_sorted[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, edge])
    last = torch.cat([edge, one])
    lo = torch.cummax(torch.where(first, i_idx, 0), 0).values
    nxt = torch.where(last, i_idx + 1, n)
    hi = torch.cummin(nxt.flip(0), 0).values.flip(0)
    return lo, hi
