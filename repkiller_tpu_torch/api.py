"""Public Python API of the port (counterpart of repkiller_tpu/api.py).

:func:`compare` returns the reference package's :class:`Result`, so the
CSV, BED and family writers are the same code. :func:`group_fragments`
clusters an existing fragments CSV into families.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repkiller_tpu.api import Result, SeqLike, _as_seqset
from repkiller_tpu.config import Config, DEFAULT
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.report import csv_writer

from . import device as _device


def compare(x: SeqLike, y: Optional[SeqLike] = None, cfg: Config = DEFAULT,
            backend: str = "device", keep_intermediates: Optional[str] = None,
            *, device="cuda") -> Result:
    """Compare sequence X against Y (or itself when y is None) and detect
    repeat fragments and families.

    backend "device" runs the torch pipeline on ``device`` (default
    "cuda": without a GPU this raises, it never drops to the CPU; pass
    ``device="cpu"`` to run there). backend "oracle" runs the numpy
    reference. Both give the same output."""
    if keep_intermediates:
        raise NotImplementedError(
            "keep_intermediates (staged execution with resume) is not "
            "ported yet: ROADMAP.md section 1 item 11")
    xs = _as_seqset(x)
    ys = _as_seqset(y) if y is not None else None
    codes_y = None if ys is None else ys.codes
    if backend == "device":
        frag = _device.compare(xs.codes, codes_y, cfg, device)
    elif backend == "oracle":
        frag = orc.compare(xs.codes, codes_y, cfg)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return Result(frag=frag, cfg=cfg, x=xs, y=ys)


def group_fragments(frags_csv, cfg: Config = DEFAULT, self_cmp: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Read a fragments CSV, cluster it into repeat families on the host
    and return the canonical-sorted fragment dict with a fresh "group"
    column."""
    frag = csv_writer.read_frags_csv(frags_csv)
    frag.pop("_meta", None)
    frag = orc.canonical_sort(frag)
    frag["group"] = _device.group_families(frag, cfg, self_cmp)
    return frag
