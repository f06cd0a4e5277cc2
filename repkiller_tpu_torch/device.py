"""Single-device comparison pipeline (counterpart of
repkiller_tpu/device.py): codes -> k-mer index -> both strands' seed hits
-> diagonal thinning -> gated extension -> merge/accept, as torch ops on
one device, then host-side family clustering. A self-comparison seeds
from one canonical index; a pairwise comparison joins the sorted index
of X with that of Y (strand f) or of revcomp(Y) (strand r).

Arrays are sized by the Config's capacities with validity masks; the true
counts come back so that overflow raises instead of truncating. Output is
the reference's, field for field.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .chain.diagonal import extend_gated
from .chain.merge import merge_accept
from .config import Config
from .families import cluster_families
from .index.build import build_index
from .index.canonical import build_canonical_index
from .oracle import pipeline as orc
from .seeds.filter import filter_hits
from .seeds.join import join_hits
from .seeds.self_join import join_self_canonical


def revcomp_device(codes: torch.Tensor) -> torch.Tensor:
    """Reverse complement; N (code 4) stays N."""
    return torch.where(codes < 4, 3 - codes, codes).flip(0)


def self_seeds_fn(cx: torch.Tensor, cfg: Config):
    """Self-comparison seeds of every requested strand from one canonical
    index -> {strand: (spx, spy, svalid, n_seeds, total_hits)}."""
    ci = build_canonical_index(cx, cfg.k)
    hits_f, hits_r = join_self_canonical(ci, cfg.k, cfg.max_occ,
                                         cfg.hit_capacity, y_len=cx.shape[0])
    out = {}
    if "f" in cfg.strands:
        out[0] = filter_hits(*hits_f[:3], cfg.min_hit_dist,
                             out_capacity=cfg.seed_cap) + (hits_f[3],)
    if "r" in cfg.strands:
        out[1] = filter_hits(*hits_r[:3], cfg.min_hit_dist,
                             out_capacity=cfg.seed_cap) + (hits_r[3],)
    return out


def pair_seeds_fn(idx_x, cy_cmp: torch.Tensor, cfg: Config):
    """Pairwise seeds of one strand: X's sorted index ``idx_x`` joined with
    that of ``cy_cmp`` (Y, or revcomp(Y) for strand r), then thinned ->
    (spx, spy, svalid, n_seeds, total_hits). The seeding half of the
    reference's ``_one_strand``."""
    kx, pxi, nxv = idx_x
    ky, pyi, nyv = build_index(cy_cmp, cfg.k)
    hpx, hpy, hvalid, total = join_hits(
        kx, pxi, nxv, ky, pyi, nyv, k=cfg.k, max_occ=cfg.max_occ,
        capacity=cfg.hit_capacity, y_len=cy_cmp.shape[0])
    return filter_hits(hpx, hpy, hvalid, cfg.min_hit_dist,
                       out_capacity=cfg.seed_cap) + (total,)


def compare_fn(cx: torch.Tensor, cy: Optional[torch.Tensor], cfg: Config,
               timings: Optional[dict] = None):
    """Comparison of ``cx`` against ``cy`` (``None``: against itself) on
    their device -> (frag, n_frags, total_hits, n_seeds), all tensors.
    ``timings`` (optional dict) gathers wall seconds per stage ("seeds",
    "extend", "merge"), each ended by a device synchronisation."""
    def lap(name, t0):
        if timings is None:
            return t0
        if cx.is_cuda:
            torch.cuda.synchronize(cx.device)
        t1 = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + t1 - t0
        return t1

    t = time.perf_counter()
    self_cmp = cy is None
    cy = cx if self_cmp else cy
    ys = {strand: cy if strand == 0 else revcomp_device(cy)
          for strand in (0, 1) if "fr"[strand] in cfg.strands}
    if self_cmp:
        seeds = self_seeds_fn(cx, cfg)
    else:
        idx_x = build_index(cx, cfg.k)
        seeds = {strand: pair_seeds_fn(idx_x, y, cfg) for strand, y in ys.items()}
    t = lap("seeds", t)
    frags, valids, totals, nseeds = [], [], [], []
    for strand, (spx, spy, sv, n_seeds, total) in seeds.items():
        frag, fv = extend_gated(spx, spy, sv, cx, ys[strand], cfg,
                                n_live=n_seeds)
        frag["strand"] = torch.where(fv, strand, 0).to(torch.int32)
        frags.append(frag)
        valids.append(fv)
        totals.append(total)
        nseeds.append(n_seeds)
    t = lap("extend", t)
    frag = {f: torch.cat([fr[f] for fr in frags]) for f in frags[0]}
    out, _, n_frags = merge_accept(frag, torch.cat(valids), cfg.min_len,
                                   cfg.min_identity, y_len=cy.shape[0])
    lap("merge", t)
    return out, n_frags, torch.stack(totals), torch.stack(nseeds)


def check_device(device) -> torch.device:
    """The torch.device to run on; a CUDA device without a usable GPU
    raises (the pipeline never drops to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def compare(codesX: np.ndarray, codesY: Optional[np.ndarray], cfg: Config,
            device, timings: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """Comparison of ``codesX`` against ``codesY`` (``None``: against
    itself) on ``device`` -> the canonical fragment dict (original
    coordinates, numpy, compacted to the true count) with the
    host-computed "group" family column. Raises on hit, seed and fragment
    capacity overflow. ``timings`` as in compare_fn, plus "families" for
    the host clustering."""
    dev = check_device(device)
    self_cmp = codesY is None
    codes_x = np.asarray(codesX, np.uint8)
    codes_y = codes_x if self_cmp else np.asarray(codesY, np.uint8)
    if codes_x.shape[0] < cfg.k or codes_y.shape[0] < cfg.k:
        frag = {f: np.zeros(0, np.int32) for f in orc.FRAG_FIELDS}
        frag["group"] = np.zeros(0, np.int32)
        return frag
    cx = torch.from_numpy(codes_x.copy()).to(dev)
    cy = None if self_cmp else torch.from_numpy(codes_y.copy()).to(dev)
    out, n_frags, total_hits, n_seeds = compare_fn(cx, cy, cfg, timings)

    total_hits = total_hits.cpu().numpy()
    if (total_hits > cfg.hit_capacity).any():
        raise ValueError(
            f"hit_capacity={cfg.hit_capacity} overflow: strand hit totals "
            f"{total_hits.tolist()}; raise Config.hit_capacity")
    n_seeds = n_seeds.cpu().numpy()
    if (n_seeds > cfg.seed_cap).any():
        raise ValueError(
            f"seed_capacity={cfg.seed_cap} overflow: strand seed counts "
            f"{n_seeds.tolist()}; raise Config.seed_capacity")
    n = int(n_frags)
    if n > 0 and n == out["xStart"].shape[0]:
        raise ValueError(
            f"frag capacity overflow ({n} fragments fill the array); "
            "raise Config.seed_capacity / Config.hit_capacity")
    frag = {f: v[:n].cpu().numpy() for f, v in out.items()}
    t0 = time.perf_counter()
    frag["group"] = cluster_families(frag, cfg, self_cmp)
    if timings is not None:
        timings["families"] = timings.get("families", 0.0) + time.perf_counter() - t0
    return frag
