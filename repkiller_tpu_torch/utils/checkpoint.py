"""Per-stage intermediate checkpointing (counterpart of
repkiller_tpu/utils/checkpoint.py, whose file names, npz keys and
fingerprint it keeps, so that either package resumes from the other's
stage files).

device.compare_staged dumps each logical stage's arrays (thinned seeds
per strand, extension fragments per strand) as .npz keyed by a content
fingerprint (genome bytes + Config), and a rerun with the same
fingerprint reloads instead of recomputing. The streamed driver has its
own finer-grained manifest (dist/windows.py).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np


def fingerprint(cx: np.ndarray, cy: Optional[np.ndarray], cfg) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(cx).tobytes())
    if cy is not None:
        h.update(b"|y|")
        h.update(np.asarray(cy).tobytes())
    h.update(repr(cfg).encode())
    return h.hexdigest()[:16]


class StageStore:
    """Dump/reload named stages as flat {str: ndarray} dicts."""

    def __init__(self, out_dir: str, fp: str):
        self.dir = out_dir
        self.fp = fp
        os.makedirs(out_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"stage_{self.fp}_{name}.npz")

    def load(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(name)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def save(self, name: str, arrays: Dict[str, np.ndarray]) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)
