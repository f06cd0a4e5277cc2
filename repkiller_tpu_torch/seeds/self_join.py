"""Both-strand seed hits of a self-comparison from one canonical index
(counterpart of repkiller_tpu/seeds/self_join.py; its docstring derives
the partner intervals). Hit sets equal the reference's; reverse hits carry
revcomp-space y coordinates."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..index.canonical import CanonIndex
from .join import owner_rows


def _expand(lo: torch.Tensor, counts: torch.Tensor, capacity: int,
            pos: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot t of the static-capacity output -> (source position, partner
    index, valid, total)."""
    n = counts.shape[0]
    dev = counts.device
    csum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = csum[-1] if n > 0 else torch.zeros((), dtype=torch.int32, device=dev)
    offs = csum - counts
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    rows = owner_rows(counts, offs, capacity, (lo, pos))
    y_idx = rows[:, 1] + (t - rows[:, 0])
    return rows[:, 2], y_idx, t < total, total


def join_self_canonical(ci: CanonIndex, k: int, max_occ: int, capacity: int,
                        y_len: int, entry_slice: Optional[Tuple[int, int]] = None):
    """-> ((hpx_f, hpy_f, valid_f, total_f), (hpx_r, hpy_r, valid_r,
    total_r)): forward and reverse strand hits, static capacity each, with
    the true totals so that overflow is detected by the caller.

    entry_slice (offset, blk) enumerates only the entries [offset,
    offset + blk); partner lookups still read the whole ``pos_b``. Every hit
    has one source entry, so the hit sets of slices that tile the entries
    partition the full hit set (the sharded self path's per-device split).
    As the reference's ``dynamic_slice``, the slice's start is clamped so
    that it lies inside the arrays, while entry ids count from ``offset``."""
    n = ci.pos.shape[0]
    dev = ci.pos.device
    off, m = (0, n) if entry_slice is None else map(int, entry_slice)
    start = min(max(off, 0), n - m)
    pos, flag, palin, run_lo, run_mid, run_hi, own_rank, alt_before = (
        a[start:start + m] for a in (ci.pos, ci.flag, ci.palin, ci.run_lo,
                                     ci.run_mid, ci.run_hi, ci.own_rank,
                                     ci.alt_before))

    xi = off + torch.arange(m, dtype=torch.int32, device=dev)
    is_valid = xi < ci.n_valid
    f0 = flag == 0
    own_lo = torch.where(f0, run_lo, run_mid)
    own_hi = torch.where(f0, run_mid, run_hi)
    alt_lo = torch.where(f0, run_mid, run_lo)
    alt_hi = torch.where(f0, run_hi, run_mid)
    own_n = own_hi - own_lo
    alt_n = alt_hi - alt_lo
    run_n = run_hi - run_lo
    slot = own_lo + own_rank                         # my B slot

    # forward: same k-mer, px < py (palindromic runs are all flag 0)
    keep_f = is_valid & (own_n <= max_occ)
    f_lo = slot + 1
    cnt_f = torch.where(keep_f, torch.clamp(own_hi - f_lo, min=0), 0)
    px_f, yi_f, valid_f, total_f = _expand(f_lo, cnt_f, capacity, pos)
    hpx_f = torch.where(valid_f, px_f, 0)
    hpy_f = torch.where(valid_f, ci.pos_b[torch.clamp(yi_f, 0, n - 1)], 0)

    # reverse: km_p == rc(km_q), p <= q (palindrome self pair kept once)
    occ_ry = torch.where(palin, run_n, alt_n)
    keep_r = is_valid & (own_n <= max_occ) & (occ_ry <= max_occ)
    r_lo = torch.where(palin, slot, alt_lo + alt_before)
    r_hi = torch.where(palin, run_hi, alt_hi)
    cnt_r = torch.where(keep_r, torch.clamp(r_hi - r_lo, min=0), 0)
    px_r, yi_r, valid_r, total_r = _expand(r_lo, cnt_r, capacity, pos)
    hpx_r = torch.where(valid_r, px_r, 0)
    q = ci.pos_b[torch.clamp(yi_r, 0, n - 1)]
    hpy_r = torch.where(valid_r, (y_len - k) - q, 0)

    return ((hpx_f, hpy_f, valid_f, total_f),
            (hpx_r, hpy_r, valid_r, total_r))
