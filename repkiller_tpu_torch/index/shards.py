"""Physically sharded k-mer indexes of the sharded backend (counterpart of
repkiller_tpu/index/shards.py, whose docstring gives the design).

Ownership: k-mer ``km`` belongs to shard ``km >> (2k - log2 n_shard)``, the
prefix ``seeds.join.join_hits(shard=)`` filters by, so each k-mer's run lives
in one shard. A canonical entry belongs to the top log2(n_shard) bits of
``canon * 2654435761 mod 2^32``.

Three index builds, each with the reference's output:

- :func:`build_sharded_index`: one global sort, then boundary slicing into
  ``(n_shard, cap_shard)`` rows padded with SENTINEL (a one-body mesh).
- :func:`build_sharded_index_dist` and :func:`build_canonical_dist`: the
  position space is cut into one chunk per (d, s) body; each body sorts its
  chunk and cuts it into per-destination-shard send blocks of ``cap_blk``
  slots, padded with (SENTINEL, MAXP); the blocks go through an all-to-all
  along the shard axis and an all-gather along the data axis; one sort per
  shard finishes the build. They run on a ``dist.mesh.Mesh``, stage by
  stage, and return per-body values ``{(d, s): ...}``: body (d, s) holds
  shard s's rows. Pads carry pos MAXP, so they sort after a valid all-T
  k=16 k-mer, whose value equals SENTINEL.

Keys are int64 tensors carrying uint32 k-mers, as in ``index.build``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import SENTINEL, build_index, extract_kmers
from .canonical import canon_posfp, canon_scans
from ..dist.mesh import DATA_AXIS, SHARD_AXIS, Mesh

MAXP = (1 << 31) - 1      # pad position: sorts after any valid position
_KNUTH = 2654435761


def shard_capacity(n_pos: int, n_shard: int, slack: float) -> int:
    """Static per-shard row capacity: slack * n / n_shard, 8-aligned,
    never above n (the n_shard == 1 degenerate case)."""
    cap = -(-int(n_pos * slack) // n_shard)
    cap = -(-cap // 8) * 8
    return max(8, min(-(-n_pos // 8) * 8, cap))


def _prefix_shift(k: int, n_shard: int) -> int:
    if n_shard & (n_shard - 1):
        raise ValueError(f"n_shard must be a power of two, got {n_shard}")
    shift = 2 * k - (n_shard - 1).bit_length()
    if n_shard > 1 and shift <= 0:
        raise ValueError(f"physical sharding needs n_shard < 4**k (k={k}, "
                         f"n_shard={n_shard})")
    return shift


def _slice_rows(key_s: torch.Tensor, vals, b: torch.Tensor, cap: int, pads):
    """Rows [b[j], b[j+1]) of the sorted ``key_s`` and of each of ``vals``,
    cut into ``cap``-slot rows padded with ``pads`` -> one (len(b) - 1, cap)
    tensor per input and the rows' true counts."""
    n = key_s.shape[-1]
    rows = b[..., :-1, None] + torch.arange(cap, dtype=b.dtype, device=b.device)
    ok = rows < b[..., 1:, None]
    idx = rows.clamp(max=max(n - 1, 0)).to(torch.int64)
    out = [torch.where(ok, a[idx], pad) for a, pad in zip((key_s, *vals), pads)]
    return out, b[..., 1:] - b[..., :-1]


def build_sharded_index(codes: torch.Tensor, k: int, n_shard: int,
                        cap_shard: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (kS int64[n_shard, cap_shard], pS int32[n_shard, cap_shard],
    cnt int32[n_shard]): row s holds shard s's (kmer, pos) entries sorted
    by (kmer, pos), SENTINEL-padded (pos 0); cnt[s] is the true count (the
    caller raises when cnt > cap_shard)."""
    shift = _prefix_shift(k, n_shard)
    km_s, pos_s, n_valid = build_index(codes, k)
    dev = km_s.device
    if n_shard == 1:
        b_lo = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        bounds = torch.arange(n_shard, dtype=torch.int64, device=dev) << shift
        b_lo = torch.searchsorted(km_s, bounds).to(torch.int32)
        b_lo = torch.minimum(b_lo, n_valid)
    b = torch.cat([b_lo, n_valid.reshape(1)])
    (kS, pS), cnt = _slice_rows(km_s, (pos_s,), b, cap_shard, (SENTINEL, 0))
    return kS, pS, cnt


def _chunking(codes: torch.Tensor, k: int, mesh: Mesh):
    """Chunk length and the N-padded codes: one chunk of positions per
    body, the tail chunk padded with invalid k-mers."""
    L = codes.shape[0]
    chunk = -(-(L - k + 1) // mesh.size)
    pad_to = mesh.size * chunk + k - 1
    if pad_to > L:
        codes = torch.cat([codes, torch.full((pad_to - L,), 4, dtype=codes.dtype,
                                             device=codes.device)])
    return chunk, codes


def _chunk_of(mesh: Mesh, body) -> int:
    return body[0] * mesh.n_shard + body[1]


def _kmer_send_blocks(codes_pad: torch.Tensor, i: int, chunk: int, k: int,
                      n_shard: int, shift: int, cap_blk: int):
    """Chunk i's k-mers sorted by (kmer, invalid, pos) and cut into one
    send block per destination shard -> (kB int64[n_shard, cap_blk],
    pB int32[n_shard, cap_blk], per-block counts)."""
    km, pos, valid = extract_kmers(codes_pad[i * chunk:(i + 1) * chunk + k - 1], k)
    pos = pos + i * chunk
    km = torch.where(valid, km, SENTINEL)
    key = (((km - (1 << 31)) << 32) | ((~valid).to(torch.int64) << 31)
           | pos.to(torch.int64))
    perm = torch.sort(key).indices
    kmS, posS = km[perm], pos[perm]
    nv = valid.sum(dtype=torch.int32).reshape(1)
    if n_shard == 1:
        b_lo = torch.zeros(1, dtype=torch.int32, device=km.device)
    else:
        bounds = torch.arange(n_shard, dtype=torch.int64, device=km.device) << shift
        b_lo = torch.minimum(torch.searchsorted(kmS, bounds).to(torch.int32), nv)
    (kB, pB), c_cnt = _slice_rows(kmS, (posS,), torch.cat([b_lo, nv]), cap_blk,
                                  (SENTINEL, MAXP))
    return kB, pB, c_cnt


def _distributed(codes: dict, k: int, mesh: Mesh, slack: float, send_blocks):
    """The shared part of both distributed builds: each body cuts its chunk
    of positions into send blocks (``send_blocks(codes_pad, chunk index,
    chunk, cap_blk)`` -> (keys, values, per-block counts)); the blocks go
    to their owner shard (all-to-all along the shard axis) and a shard
    collects them from every data row (all-gather along the data axis).
    -> {body: (received keys, received values, true per-shard counts,
    blk_over [largest block, cap_blk])}."""
    chunk, pad = None, {}
    for b, c in codes.items():
        chunk, pad[b] = _chunking(c, k, mesh)
    cap_blk = shard_capacity(chunk, mesh.n_shard, slack)
    blocks = mesh.map(lambda b, c: send_blocks(c, _chunk_of(mesh, b), chunk,
                                               cap_blk), pad)
    kr, pr, cnt = ({b: v[i] for b, v in blocks.items()} for i in range(3))
    kr = mesh.all_gather(mesh.all_to_all(kr, SHARD_AXIS), DATA_AXIS)
    pr = mesh.all_gather(mesh.all_to_all(pr, SHARD_AXIS), DATA_AXIS)
    # every chunk's counts on every body: the true shard totals, the
    # largest block
    cnt = mesh.all_gather(mesh.all_gather(cnt, SHARD_AXIS, tiled=False),
                          DATA_AXIS, tiled=False)
    return {b: (kr[b].reshape(-1), pr[b].reshape(-1),
                cnt[b].sum(dim=(0, 1), dtype=torch.int32),
                torch.stack([cnt[b].max(), torch.tensor(
                    cap_blk, dtype=cnt[b].dtype, device=cnt[b].device)]))
            for b in mesh.bodies}


def _merge_sorted(kf: torch.Tensor, pf: torch.Tensor, cap_shard: int):
    """One (key, value) sort of a shard's received entries, padded or cut
    to cap_shard (keys < 2^32, values < 2^31: one int64 key)."""
    if kf.shape[0] < cap_shard:
        pad = cap_shard - kf.shape[0]
        kf = torch.cat([kf, kf.new_full((pad,), SENTINEL)])
        pf = torch.cat([pf, pf.new_full((pad,), MAXP)])
    key = torch.sort((kf << 31) | pf.to(torch.int64)).values[:cap_shard]
    return key >> 31, key & MAXP


def build_sharded_index_dist(codes: dict, k: int, cap_shard: int, mesh: Mesh,
                             slack: float) -> dict:
    """Distributed build of the sharded k-mer index over ``mesh`` from the
    replicated ``codes`` ({body: uint8 tensor}) -> {body: (kS, pS, cnt,
    blk_over)}: body (d, s) holds shard s's row of build_sharded_index
    (kS int64[cap_shard], pS int32[cap_shard]), cnt the true per-shard
    counts int32[n_shard] and blk_over [largest send block, cap_blk]; the
    caller raises a shard_slack overflow when blk_over[0] > blk_over[1]."""
    shift = _prefix_shift(k, mesh.n_shard)

    def finish(b, got):
        kf, pf, cnt, blk_over = got
        ks, ps = _merge_sorted(kf, pf, cap_shard)
        ok = torch.arange(cap_shard, device=ks.device) < cnt[b[1]]
        return (torch.where(ok, ks, SENTINEL),
                torch.where(ok, ps, 0).to(torch.int32), cnt, blk_over)
    return mesh.map(finish, _distributed(
        codes, k, mesh, slack, lambda c, i, chunk, cap_blk: _kmer_send_blocks(
            c, i, chunk, k, mesh.n_shard, shift, cap_blk)))


def _canon_send_blocks(codes_pad: torch.Tensor, i: int, chunk: int, k: int,
                       n_shard: int, cap_blk: int):
    """Chunk i's canonical entries sorted by (owner, canon, posfp) and cut
    into one send block per destination shard -> (canon blocks, posfp
    blocks, per-block counts). Invalid entries take owner n_shard, after
    every real shard."""
    canon, posfp, valid = canon_posfp(codes_pad[i * chunk:(i + 1) * chunk + k - 1], k)
    posfp = posfp + ((i * chunk) << 2)
    if n_shard == 1:
        owner = torch.zeros_like(canon)
    else:
        bits = (n_shard - 1).bit_length()
        owner = ((canon * _KNUTH) & 0xFFFFFFFF) >> (32 - bits)
    owner = torch.where(valid, owner, n_shard)
    # (canon, posfp) pairs are unique: sort by them, then stably by owner
    perm = torch.sort((canon << 31) | posfp).indices
    perm = perm[torch.sort(owner[perm], stable=True).indices]
    ownS, canS, pfS = owner[perm], canon[perm], posfp[perm]
    nv = valid.sum(dtype=torch.int32).reshape(1)
    if n_shard == 1:
        b_lo = torch.zeros(1, dtype=torch.int32, device=canon.device)
    else:
        bounds = torch.arange(n_shard, dtype=torch.int64, device=canon.device)
        b_lo = torch.minimum(torch.searchsorted(ownS, bounds).to(torch.int32), nv)
    (kB, pB), c_cnt = _slice_rows(canS, (pfS,), torch.cat([b_lo, nv]), cap_blk,
                                  (SENTINEL, MAXP))
    return kB, pB, c_cnt


def build_canonical_dist(codes: dict, k: int, cap_shard: int, mesh: Mesh,
                         slack: float) -> dict:
    """Distributed build of the hash-sharded canonical index over ``mesh``
    from the replicated ``codes`` -> {body: (ci, cnt, blk_over)}: body
    (d, s) holds shard s's CanonIndex, its entries sorted by (canon, posfp)
    with shard-local B slots and ``n_valid`` = cnt[s]; cnt and blk_over as
    in :func:`build_sharded_index_dist`."""
    _prefix_shift(k, mesh.n_shard)

    def finish(b, got):
        kf, pf, cnt, blk_over = got
        return canon_scans(*_merge_sorted(kf, pf, cap_shard), cnt[b[1]]), cnt, blk_over
    return mesh.map(finish, _distributed(
        codes, k, mesh, slack, lambda c, i, chunk, cap_blk: _canon_send_blocks(
            c, i, chunk, k, mesh.n_shard, cap_blk)))
