"""Seed extension (counterpart of repkiller_tpu/extend/__init__.py):
ungapped x-drop (kernel K2) and banded affine-gap Gotoh (kernel K1), each a
hand-written CUDA kernel beside its plain torch version, and the wrappers
around them. The tensors' device picks kernel or plain version, so the
JAX package's ``ungapped_impl`` and ``banded_impl`` choices change nothing
here."""

from __future__ import annotations

from ..config import Config
from .banded_kernel import extend_banded
from .ungapped_kernel import extend_ungapped


def extend_dispatch(spx, spy, svalid, cx, cy, cfg: Config, n_live=None):
    """Extend seeds -> fragment dict; picks the kernel by cfg.extend_mode."""
    kw = dict(k=cfg.k, match=cfg.match, mismatch=cfg.mismatch,
              x_drop=cfg.x_drop, max_extend=cfg.max_extend, n_live=n_live)
    if cfg.extend_mode == "ungapped":
        return extend_ungapped(spx, spy, svalid, cx, cy, **kw)
    return extend_banded(spx, spy, svalid, cx, cy, band=cfg.band,
                         gap_open=cfg.gap_open, gap_extend=cfg.gap_extend, **kw)
