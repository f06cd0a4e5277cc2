"""Windowed streaming comparison with incremental checkpoint/resume
(counterpart of repkiller_tpu/dist/windows.py, whose files and manifest
it reads and writes, so that either package resumes the other's run).

The genome is processed as fixed-size query windows: window w owns seed
start positions [w*win, (w+1)*win); its k-mers are joined against the
FULL Y index (built once, resident on the device), thinned per window and
extended against the full sequences. The union over windows of the
per-window seed sets IS the single-shot seed set, each seed once, in the
same order within a window, so the final merged output is the
single-shot output field for field. Per-window thinning and gating equal
the global ones because `win` is rounded to a multiple of
lcm(min_hit_dist, gate_stride): no thinning or gate bucket spans a
window boundary.

Each finished window's raw fragments are written to `out_dir` as an .npz
plus a manifest line; a rerun with the same fingerprint (genome content,
Config and window) skips completed windows, so a killed run resumes
where it stopped. The final merge/accept runs once over all windows'
fragments, then families are clustered on the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import (StageTimer, check_device, extend_strand,
                      merge_strands, pair_join, revcomp_device, thin_hits)
from ..families import cluster_families
from ..index.build import build_index
from ..table import FRAG_FIELDS, empty
from ..utils import trace


def _window_seeds(cx_pad: torch.Tensor, cy_len: int, idxY, idxX_occ, w0: int,
                  cfg: Config, self_mode: Optional[str], win: int):
    """Window k-mers -> joined, thinned seeds: (spx, spy, svalid, n_seeds,
    total_hits). The window's index is built from its ``win + k - 1``
    codes (N-padded past X's end) and ``w0`` is added to its positions, so
    its entries are the whole-genome index's for those positions, in the
    same order."""
    km, pos, nv = build_index(cx_pad[w0:w0 + win + cfg.k - 1], cfg.k)
    hpx, hpy, hv, total = pair_join((km, pos + w0, nv), idxY, cy_len, cfg,
                                    self_mode, idxX_occ)
    return thin_hits(hpx, hpy, hv, cfg) + (total,)


def _fingerprint(cx: np.ndarray, cy: Optional[np.ndarray], cfg: Config,
                 win: int) -> str:
    h = hashlib.sha256()
    h.update(cx.tobytes())
    if cy is not None:
        h.update(cy.tobytes())
    h.update(repr((cfg, win)).encode())
    return h.hexdigest()[:16]


def compare_streamed(codesX: np.ndarray, codesY: Optional[np.ndarray],
                     cfg: Config, out_dir: Optional[str] = None,
                     window: Optional[int] = None, resume: bool = True, *,
                     device="cuda", stats: Optional[dict] = None
                     ) -> Dict[str, np.ndarray]:
    """Streamed equivalent of device.compare: the same output, with hit
    and seed arrays sized for one window (Config.hit_capacity and
    seed_capacity hold per window; overflow raises naming the window).

    out_dir enables incremental checkpointing: each window's raw fragment
    block is written as soon as it completes, and a rerun with identical
    inputs skips finished windows (manifest.jsonl). Without out_dir the
    stream runs in memory only, its blocks kept on the device. The
    default device "cuda" raises without a GPU. ``stats`` (optional dict)
    gathers wall seconds per stage ("index", "seeds", "extend", "io",
    "merge", "families"; a device stage ends in a synchronisation), the
    window count ("windows") and, over the windows computed in this run,
    the per-strand sums of their hit totals and seed counts ("hit_totals",
    "seed_counts").
    """
    dev = check_device(device)
    self_cmp = codesY is None
    cx = np.asarray(codesX, np.uint8)
    cy = cx if self_cmp else np.asarray(codesY, np.uint8)
    if cx.shape[0] < cfg.k or cy.shape[0] < cfg.k:
        return empty()

    quantum = int(np.lcm(cfg.min_hit_dist, max(cfg.gate_stride, 1)))
    win = int(window or cfg.window)
    win = max(quantum, win - win % quantum)
    n_pos = cx.shape[0] - cfg.k + 1
    n_win = -(-n_pos // win)
    cx_pad = np.full(n_win * win + cfg.k - 1, 4, np.uint8)
    cx_pad[: cx.shape[0]] = cx

    fp = _fingerprint(cx, None if self_cmp else cy, cfg, win)
    manifest = os.path.join(out_dir, "manifest.jsonl") if out_dir else None
    done = {}
    if manifest and resume and os.path.exists(manifest):
        with open(manifest) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("fp") == fp:
                    done[(rec["window"], rec["strand"])] = rec["file"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    with trace.span("compare", device=dev):
        stage = StageTimer(stats, dev)
        with stage("index"):
            dcx = torch.from_numpy(cx.copy()).to(dev)
            dcx_pad = torch.from_numpy(cx_pad).to(dev)
            dcy = dcx if self_cmp else torch.from_numpy(cy.copy()).to(dev)
            strands = [s for s in (0, 1) if "fr"[s] in cfg.strands]
            idxX = build_index(dcx, cfg.k)
            idxX_occ = (idxX[0], idxX[2])
        if stats is not None:
            stats["windows"] = n_win
            stats["hit_totals"] = [0] * len(strands)
            stats["seed_counts"] = [0] * len(strands)
        frags, valids = [], []
        for si, strand in enumerate(strands):
            with stage("index"):
                if strand == 0:
                    cy_cmp = dcy
                    idxY = idxX if self_cmp else build_index(cy_cmp, cfg.k)
                    self_mode = "f" if self_cmp else None
                else:
                    cy_cmp = revcomp_device(dcy)
                    idxY = build_index(cy_cmp, cfg.k)
                    self_mode = "r" if self_cmp else None
            for w in range(n_win):
                key = (w, strand)
                if key in done:
                    with stage("io"), np.load(
                            os.path.join(out_dir, done[key])) as z:
                        frags.append({f: torch.from_numpy(z[f]).to(dev)
                                      for f in FRAG_FIELDS})
                        valids.append(torch.from_numpy(z["valid"]).to(dev))
                    continue
                with stage("seeds"):
                    spx, spy, sv, n_seeds, total = _window_seeds(
                        dcx_pad, cy_cmp.shape[0], idxY, idxX_occ, w * win,
                        cfg, self_mode, win)
                    total, n_seeds_h = int(total), int(n_seeds)
                    trace.count("hits", total)
                    trace.count("seeds", n_seeds_h)
                    if total > cfg.hit_capacity:
                        raise ValueError(
                            f"window {w} strand {strand}: {total} hits "
                            f"exceed hit_capacity {cfg.hit_capacity}; "
                            "shrink window or raise capacity")
                    if n_seeds_h > cfg.seed_cap:
                        raise ValueError(
                            f"window {w} strand {strand}: {n_seeds_h} seeds "
                            f"exceed seed_capacity {cfg.seed_cap}; shrink "
                            "window or raise Config.seed_capacity")
                with stage("extend"):
                    frag, valid = extend_strand(spx, spy, sv, n_seeds, dcx,
                                                cy_cmp, cfg, strand)
                    frags.append(frag)
                    valids.append(valid)
                if stats is not None:
                    stats["hit_totals"][si] += total
                    stats["seed_counts"][si] += n_seeds_h
                if out_dir:
                    with stage("io"):
                        fname = f"win_{fp}_{strand}_{w:06d}.npz"
                        np.savez_compressed(
                            os.path.join(out_dir, fname),
                            valid=valid.cpu().numpy(),
                            **{f: v.cpu().numpy() for f, v in frag.items()})
                        with open(manifest, "a") as f:
                            f.write(json.dumps({
                                "fp": fp, "window": w, "strand": strand,
                                "file": fname, "n_seeds": n_seeds_h}) + "\n")

        with stage("merge"):
            out, _, n_frags = merge_strands(frags, valids, cy.shape[0], cfg)
            n = int(n_frags)
            if n > 0 and n == out["xStart"].shape[0]:
                raise ValueError("frag capacity overflow in final merge")
            trace.count("fragments", n)
            frag = {f: v[:n].cpu().numpy() for f, v in out.items()}
        # timed here, not as a stage: cluster_families is a span of its own
        t0 = time.perf_counter()
        frag["group"] = cluster_families(frag, cfg, self_cmp, device=dev)
        if stats is not None:
            stats["families"] = (stats.get("families", 0.0)
                                 + time.perf_counter() - t0)
    return frag
