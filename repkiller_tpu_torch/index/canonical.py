"""Canonical k-mer index: one index serving both strands of a
self-comparison (counterpart of repkiller_tpu/index/canonical.py; its
module docstring explains the layout).

The reference's two 2-key ``lax.sort``s become one int64 key each:
(canon < 2^32, posfp < 2^31) and (canon, flag << 30 | pos) both fit in
63 bits, and every key is unique, so the order is the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .build import SENTINEL, extract_kmers
from ..seeds.join import _run_bounds
from ..utils.scan import INT32_MAX

_M32 = 0xFFFFFFFF


def revcomp_kmer(km: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of big-endian 2-bit-packed k-mers (int64 holding
    the uint32 value)."""
    x = ~km & _M32                                   # complement each base
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    x = ((x << 16) & _M32) | (x >> 16)
    return x >> (32 - 2 * k)                         # realign to low bits


class CanonIndex(NamedTuple):
    pos: torch.Tensor         # int32[n]  position, (canon, pos) A order
    pos_b: torch.Tensor       # int32[n]  position, flag-major B order
    flag: torch.Tensor        # int32[n]  0: km == canon, 1: km == rc(canon)
    run_lo: torch.Tensor      # int32[n]  B-slot run start of my canon
    run_mid: torch.Tensor     # int32[n]  B-slot flag-0/flag-1 boundary
    run_hi: torch.Tensor      # int32[n]  B-slot run end (exclusive)
    own_rank: torch.Tensor    # int32[n]  same-flag entries of my run before me
    alt_before: torch.Tensor  # int32[n]  opposite-flag entries before me
    palin: torch.Tensor       # bool[n]   canon == rc(canon)
    n_valid: torch.Tensor     # int32     valid prefix length (A order)


def canon_posfp(codes: torch.Tensor, k: int):
    """Per-position (canon int64, posfp int64) + validity; posfp packs
    (pos << 2) | (flag << 1) | palin. Invalid positions carry
    canon = SENTINEL, which no valid canon can equal."""
    km, pos, valid = extract_kmers(codes, k)
    rc = revcomp_kmer(km, k)
    canon = torch.minimum(km, rc)
    flag = (km != canon).to(torch.int64)
    palin = (km == rc).to(torch.int64)
    canon = torch.where(valid, canon, SENTINEL)
    posfp = (pos.to(torch.int64) << 2) | (flag << 1) | palin
    return canon, posfp, valid


def canon_scans(cA: torch.Tensor, pfA: torch.Tensor, n_valid: torch.Tensor) -> CanonIndex:
    """CanonIndex from an already (canon, posfp)-sorted entry array (the
    reference's ``scan_broadcast=True`` form: run-start and run-end values
    are broadcast with a masked cummax and a reversed masked cummin)."""
    pA = (pfA >> 2).to(torch.int32)
    fA = ((pfA >> 1) & 1).to(torch.int32)
    plA = pfA & 1
    n = cA.shape[0]
    dev = cA.device
    loA, hiA = _run_bounds(cA)
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    ones_cum = torch.cumsum(fA, 0, dtype=torch.int32)   # inclusive flag-1 count
    excl = ones_cum - fA
    edge = cA[1:] != cA[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, edge])
    last = torch.cat([edge, one])
    run_start_cum = torch.cummax(torch.where(first, excl, 0), 0).values
    n1_end = torch.cummin(torch.where(last, ones_cum, INT32_MAX).flip(0),
                          0).values.flip(0)
    n1_before = excl - run_start_cum
    n0_before = (idx - loA) - n1_before
    own_rank = torch.where(fA == 1, n1_before, n0_before)
    alt_before = torch.where(fA == 1, n0_before, n1_before)
    n1_run = n1_end - run_start_cum
    midA = hiA - n1_run

    # view B: (canon, flag, pos) order, read back as positions only
    keyB, _ = torch.sort((cA << 31) | (fA.to(torch.int64) << 30) | pA.to(torch.int64))
    pos_b = (keyB & ((1 << 30) - 1)).to(torch.int32)

    lo = torch.minimum(loA, n_valid)
    hi = torch.minimum(hiA, n_valid)
    mid = torch.clamp(midA, lo, hi)
    return CanonIndex(pos=pA, pos_b=pos_b, flag=fA, run_lo=lo, run_mid=mid,
                      run_hi=hi, own_rank=own_rank, alt_before=alt_before,
                      palin=plA == 1, n_valid=n_valid)


def build_canonical_index(codes: torch.Tensor, k: int) -> CanonIndex:
    """Canonical self-comparison index: one sort of a packed
    (canon, posfp) key, then O(n) scans."""
    canon, posfp, valid = canon_posfp(codes, k)
    n_valid = valid.sum(dtype=torch.int32)
    key, _ = torch.sort((canon << 31) | posfp)
    return canon_scans(key >> 31, key & INT32_MAX, n_valid)
