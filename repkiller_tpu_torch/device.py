"""Single-device comparison pipeline (counterpart of
repkiller_tpu/device.py): codes -> k-mer index -> both strands' seed hits
-> diagonal thinning -> gated extension -> merge/accept, as torch ops on
one device, then host-side family clustering. A self-comparison seeds
from one canonical index; a pairwise comparison joins the sorted index
of X with that of Y (strand f) or of revcomp(Y) (strand r).

Arrays are sized by the Config's capacities with validity masks; the true
counts come back so that overflow raises instead of truncating. Output is
the reference's, field for field.

compare_staged is the stage sequence: it runs the stage functions one
stage at a time, each a trace span, and can dump each stage's arrays and
resume from them (utils/checkpoint.StageStore, ``keep_intermediates``).
"""

from __future__ import annotations

import contextlib
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
from .seeds.filter import filter_hits
from .seeds.join import join_hits
from .seeds.self_join import join_self_canonical
from .table import empty
from .utils import trace
from .utils.checkpoint import StageStore, fingerprint


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
        out[0] = thin_hits(*hits_f[:3], cfg) + (hits_f[3],)
    if "r" in cfg.strands:
        out[1] = thin_hits(*hits_r[:3], cfg) + (hits_r[3],)
    return out


def pair_join(idx_x, idx_y, y_len: int, cfg: Config,
              self_mode: Optional[str] = None, occ_idx=None):
    """Seed hits of X's sorted index against that of Y (or of revcomp(Y))
    -> (hpx, hpy, hvalid, total_hits); ``self_mode`` and ``occ_idx`` as in
    seeds.join.join_hits."""
    return join_hits(*idx_x, *idx_y, k=cfg.k, max_occ=cfg.max_occ,
                     capacity=cfg.hit_capacity, self_mode=self_mode,
                     y_len=y_len, occ_idx=occ_idx)


def thin_hits(hpx, hpy, hvalid, cfg: Config):
    """Diagonal thinning at the Config's seed capacity -> (spx, spy,
    svalid, n_seeds)."""
    return filter_hits(hpx, hpy, hvalid, cfg.min_hit_dist,
                       out_capacity=cfg.seed_cap)


def extend_strand(spx, spy, svalid, n_seeds, cx: torch.Tensor,
                  cy_cmp: torch.Tensor, cfg: Config, strand: int):
    """Gated extension of one strand's seeds against ``cy_cmp`` (Y, or
    revcomp(Y) for strand r) -> (frag dict with its "strand" column,
    valid mask)."""
    frag, fv = extend_gated(spx, spy, svalid, cx, cy_cmp, cfg, n_live=n_seeds)
    frag["strand"] = torch.where(fv, strand, 0).to(torch.int32)
    return frag, fv


def merge_strands(frags, valids, y_len: int, cfg: Config):
    """Merge/accept over the strands' fragment blocks -> (out, valid_out,
    n_frags)."""
    frag = {f: torch.cat([fr[f] for fr in frags]) for f in frags[0]}
    return merge_accept(frag, torch.cat(valids), cfg.min_len,
                        cfg.min_identity, y_len=y_len)


class StageTimer:
    """``with timer(name):`` runs one stage as a trace span on ``dev``
    (utils/trace.py: host and device time, never a synchronisation) and,
    with ``timings`` (a dict; None: not kept), adds the stage's wall
    seconds under ``name``, the stage then ended by a synchronisation of
    ``dev`` when it is a GPU."""

    def __init__(self, timings: Optional[dict], dev: torch.device):
        self.timings = timings
        self.dev = dev

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with trace.span(name, device=self.dev):
            yield
            if self.timings is not None and self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        if self.timings is not None:
            self.timings[name] = (self.timings.get(name, 0.0)
                                  + time.perf_counter() - t0)


def compare_staged(cx: torch.Tensor, cy: Optional[torch.Tensor], cfg: Config,
                   timings: Optional[dict] = None, store=None):
    """Comparison of ``cx`` against ``cy`` (``None``: against itself) on
    their device, stage by stage (the reference's ``compare_staged``) ->
    (frag, n_frags, total_hits, n_seeds), all tensors. ``timings``
    (optional dict) gathers wall seconds, each stage then ended by a
    device synchronisation, under the reference's stage names: self
    "seeds" (both strands from one canonical index), "extend" (per
    strand, strand r's revcomp included) and "merge"; pairwise "revcomp",
    "index_x", "index_y", "join", "filter", "extend" (per strand) and
    "merge". ``store`` (optional utils.checkpoint.StageStore)
    dumps each strand's seeds ("seeds{strand}") and extension
    ("extend{strand}") and reloads them on a rerun with the same
    fingerprint, so a stage that is reloaded is not timed."""
    dev = cx.device
    stage = StageTimer(timings, dev)
    self_cmp = cy is None
    cy_f = cx if self_cmp else cy
    strands = [s for s in (0, 1) if "fr"[s] in cfg.strands]

    def load(name):
        z = store.load(name) if store is not None else None
        return None if z is None else {f: torch.from_numpy(v).to(dev)
                                       for f, v in z.items()}

    def load_seeds(strand):
        z = load(f"seeds{strand}")
        return None if z is None else tuple(
            z[f] for f in ("spx", "spy", "sv", "n_seeds", "total"))

    def save_seeds(strand, t5):
        if store is not None:
            store.save(f"seeds{strand}", dict(zip(
                ("spx", "spy", "sv", "n_seeds", "total"),
                (t.cpu().numpy() for t in t5))))

    def load_extend(strand):
        z = load(f"extend{strand}")
        return None if z is None else (z, z.pop("fvalid"))

    def extend(strand, t5, cy_cmp, rev_y=False):
        with stage("extend"):
            if rev_y:             # strand r's revcomp, timed with its extension
                cy_cmp = revcomp_device(cy_cmp)
            frag, fv = extend_strand(*t5[:4], cx, cy_cmp, cfg, strand)
        if store is not None:
            store.save(f"extend{strand}", {
                **{f: v.cpu().numpy() for f, v in frag.items()},
                "fvalid": fv.cpu().numpy()})
        return frag, fv

    frags, valids, totals, nseeds = [], [], [], []
    if self_cmp:
        seeds = {s: load_seeds(s) for s in strands}
        if any(v is None for v in seeds.values()):
            with stage("seeds"):
                seeds = self_seeds_fn(cx, cfg)
            for s, t5 in seeds.items():
                save_seeds(s, t5)
        for strand, t5 in seeds.items():
            ext = load_extend(strand)
            if ext is None:
                ext = extend(strand, t5, cx, rev_y=strand == 1)
            frags.append(ext[0]), valids.append(ext[1])
            totals.append(t5[4]), nseeds.append(t5[3])
    else:
        idx_x = None
        for strand in strands:
            t5, ext = load_seeds(strand), load_extend(strand)
            if t5 is None or ext is None:
                cy_cmp = cy_f
                if strand == 1:
                    with stage("revcomp"):
                        cy_cmp = revcomp_device(cy_f)
            if t5 is None:
                if idx_x is None:
                    with stage("index_x"):
                        idx_x = build_index(cx, cfg.k)
                with stage("index_y"):
                    idx_y = build_index(cy_cmp, cfg.k)
                with stage("join"):
                    hpx, hpy, hv, total = pair_join(idx_x, idx_y,
                                                    cy_cmp.shape[0], cfg)
                with stage("filter"):
                    t5 = thin_hits(hpx, hpy, hv, cfg) + (total,)
                save_seeds(strand, t5)
            if ext is None:
                ext = extend(strand, t5, cy_cmp)
            frags.append(ext[0]), valids.append(ext[1])
            totals.append(t5[4]), nseeds.append(t5[3])
    with stage("merge"):
        out, _, n_frags = merge_strands(frags, valids, cy_f.shape[0], cfg)
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
            device, timings: Optional[dict] = None,
            keep_intermediates: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Comparison of ``codesX`` against ``codesY`` (``None``: against
    itself) on ``device`` -> the canonical fragment dict (original
    coordinates, numpy, compacted to the true count) with the
    host-computed "group" family column. Raises on hit, seed and fragment
    capacity overflow. Runs compare_staged, the reference's default path;
    ``timings`` gathers its stage walls under the reference's keys.

    keep_intermediates (a directory) dumps each stage's arrays there, and
    a rerun with identical inputs resumes from the last completed stage.
    The reference also takes ``staged`` because its fused program
    compiles slowly on a TPU; torch compiles nothing, so the port has no
    such option and no fused program."""
    dev = check_device(device)
    self_cmp = codesY is None
    codes_x = np.asarray(codesX, np.uint8)
    codes_y = codes_x if self_cmp else np.asarray(codesY, np.uint8)
    if codes_x.shape[0] < cfg.k or codes_y.shape[0] < cfg.k:
        return empty()
    with trace.span("compare", device=dev):
        cx = torch.from_numpy(codes_x.copy()).to(dev)
        cy = None if self_cmp else torch.from_numpy(codes_y.copy()).to(dev)
        store = (StageStore(keep_intermediates,
                            fingerprint(codesX, codesY, cfg))
                 if keep_intermediates else None)
        out, n_frags, total_hits, n_seeds = compare_staged(cx, cy, cfg,
                                                           timings, store)
        with trace.span("copy_out", device=dev):
            total_hits = total_hits.cpu().numpy()
            trace.count("hits", int(total_hits.sum()))
            if (total_hits > cfg.hit_capacity).any():
                raise ValueError(
                    f"hit_capacity={cfg.hit_capacity} overflow: strand hit "
                    f"totals {total_hits.tolist()}; raise Config.hit_capacity")
            n_seeds = n_seeds.cpu().numpy()
            trace.count("seeds", int(n_seeds.sum()))
            if (n_seeds > cfg.seed_cap).any():
                raise ValueError(
                    f"seed_capacity={cfg.seed_cap} overflow: strand seed "
                    f"counts {n_seeds.tolist()}; raise Config.seed_capacity")
            n = int(n_frags)
            if n > 0 and n == out["xStart"].shape[0]:
                raise ValueError(
                    f"frag capacity overflow ({n} fragments fill the array); "
                    "raise Config.seed_capacity / Config.hit_capacity")
            trace.count("fragments", n)
            frag = {f: v[:n].cpu().numpy() for f, v in out.items()}
        frag["group"] = cluster_families(frag, cfg, self_cmp, device=dev)
    return frag
