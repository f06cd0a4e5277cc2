"""State carried between the JAX package and the port.

This system has no weights: its state is the genome codes and the stage
intermediates (a ``CanonIndex._asdict()``, a seed tuple, a fragment dict,
the arrays ``repkiller_tpu.utils.checkpoint.StageStore`` writes). These
helpers move them between numpy, as the JAX package hands them out, and
the port's tensors with the port's dtypes: uint32 k-mers become int64
(torch's uint32 lacks ``<<`` and ``minimum`` on the CPU), every other
dtype is kept.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(arrays: Any, device) -> Any:
    """numpy array (or anything ``np.asarray`` takes), or a dict, tuple or
    list of them -> tensors on ``device``, in the same structure."""
    if isinstance(arrays, dict):
        return {k: to_torch(v, device) for k, v in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(to_torch(v, device) for v in arrays)
    a = np.array(arrays)                              # a private, writable copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def to_numpy(tensors: Any) -> Any:
    """Tensor, or a dict, tuple or list of them -> numpy arrays."""
    if isinstance(tensors, dict):
        return {k: to_numpy(v) for k, v in tensors.items()}
    if isinstance(tensors, (tuple, list)):
        return type(tensors)(to_numpy(v) for v in tensors)
    return tensors.detach().cpu().numpy()
