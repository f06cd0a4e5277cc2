"""On-device repeat-family clustering (counterpart of
repkiller_tpu/families/device.py), as torch ops on one device.

The host computes only the O(m log m) interval table and neighbor ranges
(families/cluster._edge_ranges). The device then:

- expands the ranges into edges: each edge's source interval comes from
  ``repeat_interleave`` over the range counts (the edge total is known on
  the host), its partner from the source's range start and its offset in
  the range;
- applies the length-ratio filter and drops the killed edges and
  self-edges;
- runs min-label propagation to the fixpoint: per round every edge
  scatter-mins ``min(lab[a], lab[b])`` into both endpoints, then one
  pointer-jumping gather (``lab[lab]``) halves the label-chain depth, so
  O(log n) rounds. Each round ends with one device-to-host sync on
  "changed?".

The fixpoint labels every fragment with its component's minimum fragment
index: the oracle union-find's root (union by smaller index keeps roots
minimal), so the labels equal the streamed host path's and the oracle's.
The reference pads every shape to a power of two so that XLA reuses its
compiled programs; torch compiles nothing, so nothing is padded, and the
padding changed no label.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace


def cluster_families_device(n: int, fidx: np.ndarray, counts: np.ndarray,
                            lo: np.ndarray, lens: np.ndarray, pct: int,
                            total: int, device) -> np.ndarray:
    """Family label per fragment from the interval table (``fidx``,
    ``counts``, ``lo`` in the (space, start, end, fidx) lex order of
    families/cluster._edge_ranges; ``lens`` per fragment), computed on
    ``device``. The caller guarantees ``lens.max() * 100`` fits int32.
    The edges kept by the filter and the rounds go to the trace
    (``edges``, ``rounds``). A CUDA device without a usable GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device clustering on {dev} requested but no "
                           "CUDA GPU is available")
    if not total:
        trace.count("edges", 0)
        trace.count("rounds", 0)
        return np.arange(n, dtype=np.int32)
    m = fidx.shape[0]
    # one host-to-device copy of the interval table and the lengths
    table = np.concatenate([fidx, counts, lo, lens]).astype(np.int64,
                                                           copy=False)
    fidx_d, counts_d, lo_d, lens_d = torch.from_numpy(table).to(dev).split(
        [m, m, m, n])

    src = torch.repeat_interleave(torch.arange(m, device=dev), counts_d,
                                  output_size=total)
    offs = torch.cumsum(counts_d, 0) - counts_d
    partner = lo_d[src] + (torch.arange(total, device=dev) - offs[src])
    ea, eb = fidx_d[src], fidx_d[partner]
    del src, partner
    la, lb = lens_d[ea], lens_d[eb]
    keep = (ea != eb) & (torch.minimum(la, lb) * 100
                         >= int(pct) * torch.maximum(la, lb))
    del la, lb
    ea, eb = ea[keep], eb[keep]
    trace.count("edges", ea.shape[0])

    lab = torch.arange(n, device=dev)
    rounds = 0
    while True:
        rounds += 1
        mn = torch.minimum(lab[ea], lab[eb])
        new = lab.clone()
        new.scatter_reduce_(0, ea, mn, "amin")
        new.scatter_reduce_(0, eb, mn, "amin")
        new = new[new]                               # pointer jumping
        if torch.equal(new, lab):
            break
        lab = new
    trace.count("rounds", rounds)
    return lab.to(torch.int32).cpu().numpy()
