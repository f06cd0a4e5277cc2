"""Cross-process output helpers of the sharded backend (counterpart of
repkiller_tpu/dist/merge.py).

compare_sharded already leaves the full fragment table on every rank; only
rank 0 should touch the filesystem."""

from __future__ import annotations

import torch.distributed as dist

from .mesh import process_group_active


def _world() -> int:
    return dist.get_world_size() if process_group_active() else 1


def is_output_host() -> bool:
    """True on the process that writes files: rank 0, or the only one."""
    return not process_group_active() or dist.get_rank() == 0


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
