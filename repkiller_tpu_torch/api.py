"""Public Python API of the port (counterpart of repkiller_tpu/api.py).

:func:`compare` returns the reference package's :class:`Result`, so the
CSV, BED and family writers are the same code.
"""

from __future__ import annotations

from typing import Optional

from repkiller_tpu.api import Result, SeqLike, _as_seqset
from repkiller_tpu.config import Config, DEFAULT
from repkiller_tpu.oracle import pipeline as orc

from . import device as _device


def compare(x: SeqLike, y: Optional[SeqLike] = None, cfg: Config = DEFAULT,
            device="cuda", backend: str = "device") -> Result:
    """Compare sequence X against itself (``y=None``) and detect repeat
    fragments and families.

    backend "device" runs the torch pipeline on ``device`` (default
    "cuda": without a GPU this raises, it never drops to the CPU; pass
    ``device="cpu"`` to run there). backend "oracle" runs the numpy
    reference. Both give the same output."""
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
