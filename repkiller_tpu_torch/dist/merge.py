"""Cross-process result assembly of the sharded backend (counterpart of
repkiller_tpu/dist/merge.py).

compare_sharded already leaves the full fragment table on every rank; only
rank 0 should touch the filesystem. gather_fragments assembles per-rank
row blocks that are not replicated."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..oracle import pipeline as orc
from .mesh import process_group_active


def _world() -> int:
    return dist.get_world_size() if process_group_active() else 1


def _comm_device() -> torch.device:
    """Where this rank's collectives take tensors: its card under nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_output_host() -> bool:
    """True on the process that writes files: rank 0, or the only one."""
    return not process_group_active() or dist.get_rank() == 0


def gather_fragments(frag: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's fragment rows on every rank, in the canonical total
    order; a no-op for one process. Blocks are ragged, so the counts go
    first, every column is padded to the largest count and gathered in
    sorted-key order, and each rank's padding is stripped."""
    n_proc = _world()
    if n_proc == 1:
        return frag
    dev = _comm_device()
    keys = sorted(frag)
    n_local = int(frag[keys[0]].shape[0]) if keys else 0
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n_proc)]
    dist.all_gather(counts, torch.tensor([n_local], dtype=torch.int64, device=dev))
    counts = [int(c) for c in counts]
    n_max = max(counts)
    gathered = {}
    for k in keys:
        v = np.asarray(frag[k])
        padded = torch.from_numpy(np.concatenate(
            [v, np.zeros(n_max - v.shape[0], v.dtype)])).to(dev)
        parts = [torch.empty_like(padded) for _ in range(n_proc)]
        dist.all_gather(parts, padded)
        gathered[k] = np.concatenate([p[:c].cpu().numpy()
                                      for p, c in zip(parts, counts)])
    return orc.canonical_sort(gathered)


def write_on_host0(write_fn, *args, **kw):
    """Run a writer only on the output host, then a barrier so no rank
    races ahead of complete files. The barrier runs even when the writer
    raises, so the other ranks see rank 0 fail instead of waiting forever."""
    try:
        if is_output_host():
            write_fn(*args, **kw)
    finally:
        if _world() > 1:
            dist.barrier()
