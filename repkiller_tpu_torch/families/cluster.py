"""Vectorized repeat-family clustering (repkiller proper — SURVEY.md §2.1
"Grouping heuristics"): the port's copy of repkiller_tpu/families/cluster.py,
with the whole layer on the run's CUDA device for tables large enough
(families/device.py).

Semantics are DEFINED by oracle.pipeline.cluster_families (sweep + union-
find); this is the production implementation: vectorized edge
construction (sorted intervals + searchsorted neighbor ranges, edges
expanded in bounded blocks) and min-label propagation with pointer
jumping — O(E) work a round, bounded memory, no Python per-fragment loop.
It matches the oracle bit-identically: the oracle's union-by-smaller-index
makes every union-find root the minimum member index, which is exactly the
fixpoint of min-label propagation.

Edge rule (same as oracle): the fragments' intervals (table.intervals_of)
sorted by (space, start, end, frag_idx); i links to every later j in the
same space with start_j <= end_i + proximity, provided the two
fragments' lengths are ratio-compatible:
min(la,lb)*100 >= round(len_ratio*100)*max(la,lb).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..table import intervals_of
from ..utils import trace
from .device import cluster_families_device


EDGE_CHUNK = 1 << 22   # edges materialised at once (~64 MB of working set)

# Fragments from which a CUDA device clusters on the card. Below it the
# host path is faster, as the device path's launches and its sync a round
# cost more than the host's work. The crossover, on an NVIDIA H100 80GB
# HBM3 at 700 W (random tables of about 8 edges a fragment, medians of 7
# calls; PERF.md, chip run F1): the host took 1.73 ms and the device
# 2.23 ms at 1,000 fragments, 5.41 and 3.57 ms at 2,000.
DEVICE_MIN_FRAGMENTS = 1 << 11


def _takes_device_path(frag: Dict[str, np.ndarray], device,
                       device_min_fragments: int) -> bool:
    """The device path for a table of at least ``device_min_fragments``
    fragments on a CUDA device with a GPU, or on any device when
    ``device_min_fragments`` is 0; never when a length times 100 leaves
    int32 (the reference's condition)."""
    if int(frag["length"].max(initial=0)) >= (1 << 31) // 100:
        return False
    if device_min_fragments == 0:
        return True
    return (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and frag["xStart"].shape[0] >= device_min_fragments)


def _edge_ranges(frag: Dict[str, np.ndarray], cfg: Config, self_cmp: bool):
    """Sorted interval table + per-interval neighbor ranges, on the host.
    Returns (fidx, counts, offs, lo, lens, pct, total, csum) in the
    (space, start, end, fidx) lex order."""
    space, start, end, fidx = intervals_of(frag, self_cmp)
    order = np.lexsort((fidx, end, start, space))
    space, start, end, fidx = (space[order], start[order], end[order],
                               fidx[order])
    m = space.shape[0]

    # neighbor ranges: i links to j in (i, hi_i): same space and
    # start_j <= end_i + proximity. `start` is only sorted WITHIN a
    # space, so bisect on the composite (space, start) key.
    big = np.int64(max(int(end.max(initial=0)) + cfg.proximity,
                       int(start.max(initial=0))) + 2)
    key = space.astype(np.int64) * big + start
    q = space.astype(np.int64) * big + np.minimum(
        end + np.int64(cfg.proximity), big - 1)
    reach = np.searchsorted(key, q, side="right")
    lo = np.arange(m, dtype=np.int64) + 1
    counts = np.maximum(reach - lo, 0)
    csum = np.cumsum(counts)
    total = int(csum[-1]) if m else 0
    offs = csum - counts
    lens = frag["length"].astype(np.int64)
    pct = np.int64(round(cfg.len_ratio * 100))
    return fidx, counts, offs, lo, lens, pct, total, csum


def cluster_families(frag: Dict[str, np.ndarray], cfg: Config,
                     self_cmp: bool, edge_chunk: int = EDGE_CHUNK,
                     device_min_fragments: int = DEVICE_MIN_FRAGMENTS, *,
                     device="cuda") -> np.ndarray:
    """Family id per fragment = smallest member index (canonical order).

    Fragments MUST already be canonical_sort'ed (same contract as the
    oracle implementation this replaces on the hot path).

    Memory is bounded: the edge list (sum of neighbor-range counts —
    quadratic in the worst dense pileup, though max_occ bounds realistic
    family sizes) is never materialised whole. Edges are expanded in
    ``edge_chunk`` blocks, kept while they fit a few blocks and otherwise
    regenerated per propagation round from the O(m) range arrays;
    min-label propagation reaches the same fixpoint (the per-component
    minimum) for any edge processing order, so the result is
    bit-identical to the oracle's union-find for any chunk size.

    On a CUDA ``device`` with a GPU, a table of at least
    ``device_min_fragments`` fragments is clustered there, table and all
    (families/device.py); below it, and on any other device, on the host.
    ``device_min_fragments`` 0 takes the device path on any device, which
    raises on a CUDA device without a GPU. Both paths give the same
    labels.
    """
    n = frag["xStart"].shape[0]
    with trace.span("families"):
        trace.count("fragments", n)
        if n == 0:
            return np.zeros(0, np.int32)
        if _takes_device_path(frag, device, device_min_fragments):
            return cluster_families_device(frag, cfg, self_cmp, device,
                                           edge_chunk)
        with trace.span("families.edges"):
            fidx, counts, offs, lo, lens, pct, total, csum = _edge_ranges(
                frag, cfg, self_cmp)
        with trace.span("families.propagate"):
            trace.count("path", 0)
            return _propagate_host(n, fidx, counts, offs, lo, lens, pct,
                                   total, csum, edge_chunk)


def _propagate_host(n: int, fidx, counts, offs, lo, lens, pct, total: int,
                    csum, edge_chunk: int) -> np.ndarray:
    """cluster_families' host path from the interval table of
    _edge_ranges: edges streamed in ``edge_chunk`` blocks, min-label
    propagation to the fixpoint; the kept edges, the rounds and the
    round-1 blocks go to the trace."""
    if not total:
        trace.count("blocks", 0)
        trace.count("edges", 0)
        trace.count("rounds", 0)
        return np.arange(n, dtype=np.int32)
    m = fidx.shape[0]

    # source-interval chunk boundaries carrying ~edge_chunk edges each
    # (one hub interval with more neighbors than edge_chunk makes its
    # block that big — peak memory then equals its degree, which any
    # edge representation pays anyway)
    if total > edge_chunk:
        cut = np.searchsorted(csum, np.arange(edge_chunk, total, edge_chunk,
                                              dtype=np.int64), side="left")
        bounds = np.unique(np.concatenate([[0], cut + 1, [m]]))
    else:
        bounds = np.array([0, m], dtype=np.int64)
    trace.count("blocks", bounds.shape[0] - 1)

    def gen_block(i0: int, i1: int):
        """Filtered (ea, eb) for source intervals [i0, i1) — pure
        np.repeat expansion, no per-edge binary search."""
        w = counts[i0:i1]
        tot = int(w.sum())
        if not tot:
            return None
        ea_i = np.repeat(np.arange(i0, i1, dtype=np.int64), w)
        off_local = np.repeat(offs[i0:i1], w)
        intra = np.arange(tot, dtype=np.int64) - (off_local - offs[i0])
        eb_i = np.repeat(lo[i0:i1], w) + intra
        ea, eb = fidx[ea_i], fidx[eb_i]
        keep = ea != eb
        la, lb = lens[ea], lens[eb]
        keep &= np.minimum(la, lb) * 100 >= pct * np.maximum(la, lb)
        if not keep.any():
            return None
        return ea[keep].astype(np.int32), eb[keep].astype(np.int32)

    # round 1 generates each block once and caches the filtered edges
    # while they fit ~2x edge_chunk entries; adversarial pileups beyond
    # that fall back to regenerating blocks per round (memory stays
    # bounded either way)
    cache, cache_n, cache_ok, kept = [], 0, True, 0

    def blocks(first: bool):
        nonlocal cache, cache_n, cache_ok, kept
        if not first and cache_ok:
            yield from cache
            return
        for i0, i1 in zip(bounds[:-1], bounds[1:]):
            blk = gen_block(int(i0), int(i1))
            if blk is None:
                continue
            if first:
                kept += blk[0].shape[0]
            if first and cache_ok:
                cache_n += blk[0].shape[0]
                if cache_n <= 2 * edge_chunk:
                    cache.append(blk)
                else:
                    cache, cache_ok = [], False
            yield blk

    # min-label propagation with pointer jumping to the fixpoint
    lab = np.arange(n, dtype=np.int64)
    first, rounds = True, 0
    while True:
        rounds += 1
        new = lab.copy()
        for ea, eb in blocks(first):
            la, lb = lab[ea], lab[eb]
            # already-merged endpoints contribute nothing to the min;
            # dropping them makes every round after the first nearly
            # free (ufunc.at is the cost, the gathers are cheap)
            live = la != lb
            if not live.any():
                continue
            ea, eb = ea[live], eb[live]
            m2 = np.minimum(la[live], lb[live])
            np.minimum.at(new, ea, m2)
            np.minimum.at(new, eb, m2)
        first = False
        new = np.minimum(new, new[new])             # pointer jumping
        if np.array_equal(new, lab):
            break
        lab = new
    trace.count("edges", kept)
    trace.count("rounds", rounds)
    return lab.astype(np.int32)
