"""Per-stage instrumentation (counterpart of repkiller_tpu/utils/metrics.py):
structured JSONL records with stage, wall time, bp processed, hits,
fragments and families.

`profile_stages` runs the single-device pipeline stage by stage, with a
device synchronisation after each stage, so the wall times are
attributable; it clusters with the program's families layer, on
``device`` where that layer would take it. The records carry the reference's stages and count fields;
only ``wall_s`` differs between the two packages.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..device import check_device, pair_join, thin_hits
from ..chain.merge import merge_accept
from ..extend import extend_dispatch
from ..families import cluster_families
from ..index.build import build_index


def profile_stages(codesX: np.ndarray, codesY: Optional[np.ndarray],
                   cfg: Config, emit=None, *, device="cuda") -> List[Dict]:
    """Run the pipeline on ``device`` with per-stage timing; returns
    JSONL-ready records.

    Forward strand only (timing-representative); emit is an optional
    callable for each record (e.g. print, or a file's write). The default
    device "cuda" raises without a GPU.
    """
    dev = check_device(device)
    self_cmp = codesY is None
    records: List[Dict] = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def rec(stage, t0, **kw):
        sync()
        r = {"stage": stage, "wall_s": round(time.perf_counter() - t0, 4), **kw}
        records.append(r)
        if emit:
            emit(json.dumps(r))
        return r

    t0 = time.perf_counter()
    cx = torch.from_numpy(np.array(codesX, np.uint8)).to(dev)
    cy = cx if self_cmp else torch.from_numpy(np.array(codesY, np.uint8)).to(dev)
    rec("h2d", t0, bp=int(cx.shape[0]) + (0 if self_cmp else int(cy.shape[0])))

    t0 = time.perf_counter()
    idxX = build_index(cx, cfg.k)
    idxY = idxX if self_cmp else build_index(cy, cfg.k)
    rec("index_build", t0, kmers=int(idxX[2]) + (0 if self_cmp else int(idxY[2])))

    t0 = time.perf_counter()
    hpx, hpy, hvalid, total = pair_join(idxX, idxY, int(cy.shape[0]), cfg,
                                        "f" if self_cmp else None)
    rec("seed_join", t0, hits=int(total))

    t0 = time.perf_counter()
    spx, spy, svalid, n_seeds = thin_hits(hpx, hpy, hvalid, cfg)
    rec("hit_filter", t0, seeds=int(n_seeds))

    t0 = time.perf_counter()
    frag = extend_dispatch(spx, spy, svalid, cx, cy, cfg)
    rec("extension", t0, seeds=int(n_seeds),
        cells=int(n_seeds) * 2 * cfg.max_extend * (2 * cfg.band + 1)
        if cfg.extend_mode == "banded" else None)

    t0 = time.perf_counter()
    out, vout, n_frags = merge_accept(frag, svalid, cfg.min_len,
                                      cfg.min_identity, y_len=int(cy.shape[0]))
    rec("merge_accept", t0, fragments=int(n_frags))

    t0 = time.perf_counter()
    host = {k: v[: int(n_frags)].cpu().numpy() for k, v in out.items()}
    group = cluster_families(host, cfg, self_cmp, device=dev)
    rec("families_host", t0, families=int(np.unique(group).shape[0])
        if group.size else 0)
    return records
