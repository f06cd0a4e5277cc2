"""k-mer extraction and the sorted k-mer index of one sequence
(counterpart of repkiller_tpu/index/build.py).

k-mers are held as int64 tensors carrying the uint32 value: torch's
uint32 lacks ``<<`` and ``minimum`` on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

SENTINEL = 0xFFFFFFFF


def extract_kmers(codes: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8 codes[L] -> (kmer int64[n], pos int32[n], valid bool[n]),
    n = L-k+1; big-endian 2-bit packing (first base in the top bits).
    Windows holding an N (code >= 4) are invalid."""
    L = codes.shape[0]
    n = L - k + 1
    dev = codes.device
    if n <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    km = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(k):
        w = codes[i:i + n]
        ok = w < 4
        valid &= ok
        km = (km << 2) | torch.where(ok, w, 0).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    return km, pos, valid


def build_index(codes: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted k-mer index -> (kmer int64[n], pos int32[n], n_valid int32).

    The order is (kmer, invalid, pos) with invalid windows' kmer forced to
    SENTINEL, so the valid prefix [0, n_valid) is sorted by (kmer, pos).
    The three keys pack into one int64: (kmer - 2^31) << 32 | invalid << 31
    | pos, with 0 <= pos < 2^31 and positions unique, so a plain sort gives
    the order."""
    km, pos, valid = extract_kmers(codes, k)
    km = torch.where(valid, km, SENTINEL)
    key = (((km - (1 << 31)) << 32) | ((~valid).to(torch.int64) << 31)
           | pos.to(torch.int64))
    _, perm = torch.sort(key)
    return km[perm], pos[perm], valid.sum(dtype=torch.int32)
