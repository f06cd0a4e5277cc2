"""Segmented-scan helpers and the multi-key sort of the torch pipeline.

Counterpart of repkiller_tpu/utils/scan.py. Every function works on any
device; index arithmetic is int32 like the reference, and torch's
int64-only places (sort permutations, packed keys) are cast back.
"""

from __future__ import annotations

from typing import Sequence

import torch

NEG_INF32 = -(1 << 30)
INT32_MAX = 0x7FFFFFFF


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by ``keys[0]``, then ``keys[1]``, ... ascending.

    The counterpart of ``lax.sort(keys + payload, num_keys=len(keys))``:
    ``[key[perm] for key in keys]`` are the sorted keys and any payload
    follows through ``perm``. Chained stable sorts, least significant key
    first, so rows with equal keys keep their input order, as in the
    (stable) ``lax.sort``."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        _, p = torch.sort(k, stable=True)
        perm = p if perm is None else perm[p]
    return perm


def segmented_cummax(values: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Inclusive per-segment running max of int32 ``values``.

    ``boundary[i]`` true starts a new segment at i. Each value is lifted
    into an int64 key ``segment << 32 | (value + 2^31)``: keys of a later
    segment exceed every earlier key, so one plain ``cummax`` restarts at
    each boundary."""
    seg = torch.cumsum(boundary.to(torch.int64), 0)
    key = (seg << 32) | (values.to(torch.int64) + (1 << 31))
    out = torch.cummax(key, 0).values
    return ((out & 0xFFFFFFFF) - (1 << 31)).to(values.dtype)


def partition_live(flag: torch.Tensor):
    """Stable front-compaction permutation for a boolean mask.

    Returns ``(order, dest, n_live)``: ``order`` lists live slots first
    (slot order kept within each class), ``dest`` is its inverse
    (``order[dest[i]] = i``), so a compacted result ``R`` maps back to
    slot order as ``R[dest]``. One cumsum and one scatter with unique
    indices."""
    n = flag.shape[0]
    c = torch.cumsum(flag.to(torch.int32), 0, dtype=torch.int32)
    n_live = c[-1]
    idx = torch.arange(n, dtype=torch.int32, device=flag.device)
    dest = torch.where(flag, c - 1, n_live + idx - c)
    order = torch.empty(n, dtype=torch.int32, device=flag.device)
    order[dest] = idx
    return order, dest, n_live


def prefix_in_segment(values: torch.Tensor, boundary: torch.Tensor, fill) -> torch.Tensor:
    """Exclusive per-segment prefix of an inclusive per-segment scan result:
    element 0 of each segment gets ``fill``."""
    shifted = torch.cat([values.new_full((1,), fill), values[:-1]])
    return torch.where(boundary.to(torch.bool), torch.full_like(values, fill), shifted)
