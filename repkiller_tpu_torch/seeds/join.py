"""Seed-hit join of two sorted k-mer indices (counterpart of
repkiller_tpu/seeds/join.py, whose docstring gives the design): one
merge-by-sort for the run bounds, the hyper-repeat cap, an exclusive scan
of the pair counts and static-capacity owner recovery."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils.scan import INT32_MAX

MAXP = (1 << 31) - 1      # > any valid position (genomes < 2^31 bp)


def ranks_by_sort(ka: torch.Tensor, pa: torch.Tensor, n_valid,
                  kqs: Sequence[torch.Tensor], pqs: Sequence[torch.Tensor]):
    """For each query set q, ``rank[q][i]`` = number of valid entries of
    the (kmer, pos)-sorted index with (k, p) <= (kqs[q][i], pqs[q][i]):
    the right-bisect position of the composite key.

    Targets and queries are concatenated, targets first, and sorted once,
    stably, by one int64 key (kmer - 2^31) << 32 | (pos + 2^31): kmers are
    32-bit values (SENTINEL included) and positions any int32 (-1, MAXP,
    negative anchors), so the key is exact. Stability puts every target
    before an equal-key query, as the reference's (kmer, pos, qid) sort
    with negative target qids does. The rank of a row is the running count
    of valid targets, read back into input order through the inverse
    permutation."""
    nt = ka.shape[0]
    dev = ka.device
    K = torch.cat([ka.to(torch.int64)] + [kq.to(torch.int64) for kq in kqs])
    P = torch.cat([pa.to(torch.int64)] + [pq.to(torch.int64) for pq in pqs])
    key = ((K - (1 << 31)) << 32) | (P + (1 << 31))
    _, perm = torch.sort(key, stable=True)
    counted = torch.zeros(K.shape[0], dtype=torch.int32, device=dev)
    counted[:nt] = (torch.arange(nt, dtype=torch.int32, device=dev)
                    < n_valid).to(torch.int32)
    rank = torch.empty_like(counted)
    rank[perm] = torch.cumsum(counted[perm], 0, dtype=torch.int32)
    nq = kqs[0].shape[0] if kqs else 0
    return [rank[nt + q * nq:nt + (q + 1) * nq] for q in range(len(kqs))]


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


def join_hits(kx, px, nx_valid, ky, py, ny_valid, k: int, max_occ: int,
              capacity: int, self_mode: Optional[str] = None, y_len: int = 0,
              occ_idx=None, shard=None, same_index: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Join two sorted indices (build_index's output) -> (hpx, hpy, hvalid,
    total) at static ``capacity``; ``total`` is the true pair count, so
    the caller detects overflow. Hits come in the reference's order:
    X-index order, then Y-run order.

    self_mode "f": keep px < py (the canonical half of a self-comparison;
    kx may be a window of the genome Y was built from). self_mode "r":
    keep py <= y_len - px - k (X against revcomp(X)). occ_idx (k_full,
    n_full_valid): count X-side occurrences against this full index
    (needed when kx is a window). same_index: kx/px ARE ky/py, so the run
    bounds come from scans, not a search, and the "f" bound is xi + 1.
    shard (shard_id, n_shards): keep only the X k-mers that hash-prefix
    shard shard_id owns, ``kx >> (2k - log2 n_shards)`` (``kx % n_shards``
    when that shift is not positive); n_shards must be a power of two."""
    if shard is not None and shard[1] & (shard[1] - 1):
        raise ValueError(f"n_shards must be a power of two, got {shard[1]}")
    nx = kx.shape[0]
    dev = kx.device
    xi = torch.arange(nx, dtype=torch.int32, device=dev)
    below = torch.full((nx,), -1, dtype=torch.int32, device=dev)
    above = torch.full((nx,), MAXP, dtype=torch.int32, device=dev)
    pair_rank = None
    if same_index:
        lo, hi = _run_bounds(kx)
        lo = torch.minimum(lo, ny_valid)
        hi = torch.minimum(hi, ny_valid)
    else:
        kqs, pqs = [kx, kx], [below, above]
        if self_mode == "f":
            kqs.append(kx), pqs.append(px)
        elif self_mode == "r":
            kqs.append(kx), pqs.append(y_len - px - k)  # keep py <= anchor
        ranks = ranks_by_sort(ky, py, ny_valid, kqs, pqs)
        lo, hi = ranks[0], ranks[1]
        if self_mode is not None:
            pair_rank = ranks[2]
    occ_y = hi - lo
    if same_index:
        occ_x = occ_y
    elif occ_idx is not None:
        ko, no_valid = occ_idx
        xr = ranks_by_sort(ko, torch.zeros_like(ko, dtype=torch.int32),
                           no_valid, [kx, kx], [below, above])
        occ_x = xr[1] - xr[0]
    else:
        # occurrences of each X k-mer in X itself: run scans, never a search
        xlo, xhi = _run_bounds(kx)
        occ_x = torch.minimum(xhi, nx_valid) - torch.minimum(xlo, nx_valid)
    keep = (xi < nx_valid) & (occ_x <= max_occ) & (occ_y <= max_occ)
    if shard is not None:
        shard_id, n_shards = shard
        shift = 2 * k - (int(n_shards) - 1).bit_length()
        owner = kx % n_shards if shift <= 0 else kx >> shift
        keep &= owner == shard_id

    # the exact canonical-half bounds of a self-comparison
    if self_mode == "f" and same_index:
        lo = torch.maximum(lo, xi + 1)  # entry xi is inside its own run
    elif self_mode == "f":
        lo = torch.maximum(lo, pair_rank)
    elif self_mode == "r":
        hi = torch.maximum(torch.minimum(hi, pair_rank), lo)
    counts = torch.where(keep, (hi - lo).clamp(min=0), 0)

    csum = torch.cumsum(counts, 0, dtype=torch.int32)          # inclusive
    total = csum[-1] if nx > 0 else torch.zeros((), dtype=torch.int32,
                                                device=dev)
    offs = csum - counts                                       # exclusive
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    rows = owner_rows(counts, offs, capacity, (px, lo))
    hvalid = t < total
    y_idx = rows[:, 2] + (t - rows[:, 0])
    hpy = py[y_idx.clamp(0, max(ky.shape[0] - 1, 0))]
    hpx = torch.where(hvalid, rows[:, 1], 0)
    hpy = torch.where(hvalid, hpy, 0)
    return hpx, hpy, hvalid, total
