"""On-device repeat-family clustering, as torch ops on one device.

Everything from the fragment table on runs on the device; only the labels
come back to the host. One host-to-device copy carries the five columns
the table needs (x and y coordinates and lengths). The device then:

- builds the interval table of families/cluster._edge_ranges: each
  fragment's two intervals in (space, start, end, fidx) order (two stable
  sorts over an index order that is fidx order), each interval's reach by
  ``searchsorted`` on the composite (space, start) key, the neighbour
  counts, their running sum and the edge total;
- expands the edges in blocks of at most ``edge_chunk``: edge e of the
  table's enumeration finds its source interval by ``searchsorted`` on
  the running sum and its partner from the source's range start. Each
  block drops self-edges and the pairs the length-ratio filter kills, and
  keeps the rest as int32 (ea, eb). While the kept edges number at most
  ``KEPT_BLOCKS * edge_chunk`` they stay on the device for every round;
  past that every round expands the blocks anew, so the working set is one
  block and the range arrays, whatever the table's edge total;
- runs min-label propagation to the fixpoint: per round every edge
  scatter-mins ``min(lab[a], lab[b])`` into both endpoints, then one
  pointer-jumping gather (``lab[lab]``) halves the label-chain depth, so
  O(log n) rounds, each ending in one device-to-host sync on "changed?".

The fixpoint labels every fragment with its component's minimum fragment
index: the oracle union-find's root (union by smaller index keeps roots
minimal), so the labels equal the host path's and the oracle's for any
block size and any edge order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils import trace

# kept edges held on the device across rounds, in blocks of edge_chunk:
# 8 blocks of 2^22 are 2^25 edges, 256 MB of int32 pairs
KEPT_BLOCKS = 8

_COLUMNS = ("xStart", "xEnd", "yStart", "yEnd", "length")


def edge_ranges_device(frag, cfg: Config, self_cmp: bool, device):
    """families/cluster._edge_ranges computed on ``device`` from the
    fragment table: (fidx, counts, offs, lo, lens, pct, total, csum), the
    same values in the same order, as tensors (fidx int32, the rest int64)
    but ``pct`` and ``total``."""
    dev = torch.device(device)
    n = frag["xStart"].shape[0]
    cols = np.empty((len(_COLUMNS), n), np.int64)
    for row, f in zip(cols, _COLUMNS):
        row[...] = frag[f]
    xs, xe, y0, y1, lens = torch.from_numpy(cols).to(dev).unbind()
    m = 2 * n
    # interval 2f is fragment f's x copy, 2f + 1 its y copy: the index
    # order is fidx order, and the stable sorts keep it among ties
    start = torch.stack([xs, torch.minimum(y0, y1)], 1).view(-1)
    end = torch.stack([xe, torch.maximum(y0, y1)], 1).view(-1)
    idx = torch.arange(m, device=dev)
    space = torch.zeros_like(idx) if self_cmp else idx % 2
    big = (int(torch.maximum(end.max() + cfg.proximity, start.max())) + 2
           if m else 2)
    order = torch.argsort(end, stable=True)
    order = order[torch.argsort((space * big + start)[order], stable=True)]
    start, end, space = start[order], end[order], space[order]
    fidx = (order // 2).to(torch.int32)
    del order

    # i links to j in (i, reach_i): same space, start_j <= end_i + proximity
    key = space * big + start
    q = space * big + torch.clamp(end + cfg.proximity, max=big - 1)
    del start, end, space
    reach = torch.searchsorted(key, q, right=True)
    del key, q
    lo = idx + 1
    counts = torch.clamp(reach - lo, min=0)
    del reach
    csum = torch.cumsum(counts, 0)
    total = int(csum[-1]) if m else 0
    offs = csum - counts
    pct = round(cfg.len_ratio * 100)
    return fidx, counts, offs, lo, lens, pct, total, csum


def edge_block(fidx, offs, lo, lens, pct: int, csum, e0: int, e1: int):
    """Edges [e0, e1) of the table's enumeration (source-interval order,
    partners in range order) -> the (ea, eb) int32 fragment pairs the
    filter keeps: no self-edge, lengths ratio-compatible."""
    e = torch.arange(e0, e1, device=csum.device)
    src = torch.searchsorted(csum, e, right=True)
    e += lo[src] - offs[src]                     # the partner interval
    ea, eb = fidx[src], fidx[e]
    del e, src
    la, lb = lens[ea], lens[eb]
    keep = (ea != eb) & (torch.minimum(la, lb) * 100
                         >= pct * torch.maximum(la, lb))
    del la, lb
    return ea[keep], eb[keep]


def propagate_device(n: int, fidx, offs, lo, lens, pct: int, total: int,
                     csum, edge_chunk: int) -> np.ndarray:
    """Family label per fragment from the interval table of
    edge_ranges_device, on its device -> int32 labels on the host. The
    kept edges, the rounds and the round-1 blocks go to the trace
    (``edges``, ``rounds``, ``blocks``)."""
    trace.count("blocks", -(-total // edge_chunk))
    if not total:
        trace.count("edges", 0)
        trace.count("rounds", 0)
        return np.arange(n, dtype=np.int32)
    budget = KEPT_BLOCKS * edge_chunk
    cache, kept = [], 0

    def blocks(first: bool):
        nonlocal cache, kept
        if not first and cache is not None:
            yield from cache
            return
        for e0 in range(0, total, edge_chunk):
            ea, eb = edge_block(fidx, offs, lo, lens, pct, csum, e0,
                                min(e0 + edge_chunk, total))
            if first:
                kept += ea.shape[0]
                if cache is not None and kept <= budget:
                    cache.append((ea, eb))
                else:
                    cache = None
            yield ea, eb

    lab = torch.arange(n, device=fidx.device, dtype=torch.int32)
    first, rounds = True, 0
    while True:
        rounds += 1
        new = lab.clone()
        for ea, eb in blocks(first):
            mn = torch.minimum(lab[ea], lab[eb])
            new.scatter_reduce_(0, ea, mn, "amin")
            new.scatter_reduce_(0, eb, mn, "amin")
        first = False
        new = new[new]                               # pointer jumping
        if torch.equal(new, lab):
            break
        lab = new
    trace.count("edges", kept)
    trace.count("rounds", rounds)
    return lab.cpu().numpy()


def cluster_families_device(frag, cfg: Config, self_cmp: bool, device,
                            edge_chunk: int) -> np.ndarray:
    """Family label per fragment (canonical-sorted ``frag``, at least one
    fragment), the table and the propagation on ``device``: the
    "families.edges" and "families.propagate" spans, timed on a CUDA
    device's stream too. A CUDA device without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device clustering on {dev} requested but no "
                           "CUDA GPU is available")
    with trace.span("families.edges", device=dev):
        fidx, _, offs, lo, lens, pct, total, csum = edge_ranges_device(
            frag, cfg, self_cmp, dev)
    with trace.span("families.propagate", device=dev):
        trace.count("path", 1)
        return propagate_device(frag["xStart"].shape[0], fidx, offs, lo,
                                lens, pct, total, csum, edge_chunk)
