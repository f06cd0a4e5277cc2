"""Fragment merge, acceptance and canonical ordering (counterpart of
repkiller_tpu/chain/merge.py; its docstring proves the parallel overlap-run
identity used here). Every sort is over a total order of keys, through
utils.scan.lexsort."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.scan import NEG_INF32, lexsort, prefix_in_segment, segmented_cummax

_FIELDS = ("strand", "xStart", "yStart", "xEnd", "yEnd", "length", "score", "idents")


def _sort_frags(frag: Dict[str, torch.Tensor], lead_keys) -> Tuple:
    """Sort fragment columns by lead_keys + every field (a total order)."""
    cols = [frag[f] for f in _FIELDS]
    perm = lexsort(list(lead_keys) + cols)
    lead = tuple(k[perm] for k in lead_keys)
    return lead, {f: c[perm] for f, c in zip(_FIELDS, cols)}


def _changed(a: torch.Tensor) -> torch.Tensor:
    """a[i] != a[i-1], with a[0] compared to a[-1] (jnp.roll semantics)."""
    return a != torch.roll(a, 1)


def merge_accept(frag: Dict[str, torch.Tensor], valid: torch.Tensor,
                 min_len: int, min_identity: float, y_len: int
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Merge overlapping same-diagonal fragments (the best survives), apply
    length/identity acceptance, map reverse-strand y to original
    coordinates, canonical-sort and compact -> (frag, valid, n_frags)."""
    n = frag["xStart"].shape[0]
    dev = valid.device
    inv = (~valid).to(torch.int32)
    diag = frag["xStart"] - frag["yStart"]

    # pass 1: (inv, diag, strand, xStart, ...) order -> overlap runs
    (inv_s, diag_s), f = _sort_frags(frag, (inv, diag))
    valid_s = inv_s == 0
    group = _changed(diag_s) | _changed(f["strand"]) | _changed(valid_s)
    group[0] = True
    run_end_incl = segmented_cummax(f["xEnd"], group)
    run_end_excl = prefix_in_segment(run_end_incl, group, NEG_INF32)
    run_start = group | (f["xStart"] > run_end_excl)
    run_id = torch.cumsum(run_start.to(torch.int32), 0, dtype=torch.int32)

    # pass 2: the winner of each run maximises (score, length, -xStart, ...)
    (inv2, rid2, _, _), f2 = _sort_frags(f, (inv_s, run_id, -f["score"],
                                              -f["length"]))
    first = _changed(rid2)
    first[0] = True
    win = (inv2 == 0) & first

    pct = int(round(min_identity * 100))
    win = win & (f2["length"] >= min_len) \
        & (f2["idents"] * 100 >= pct * f2["length"])

    r = f2["strand"] == 1
    f2["yStart"] = torch.where(r, (y_len - 1) - f2["yStart"], f2["yStart"])
    f2["yEnd"] = torch.where(r, (y_len - 1) - f2["yEnd"], f2["yEnd"])

    # canonical order + compaction
    f2 = {k: torch.where(win, v, 0) for k, v in f2.items()}
    _, f3 = _sort_frags(f2, ((~win).to(torch.int32),))
    n_frags = win.sum(dtype=torch.int32)
    valid_out = torch.arange(n, dtype=torch.int32, device=dev) < n_frags
    return f3, valid_out, n_frags
