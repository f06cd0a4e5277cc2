"""Sharded comparison over a (data, shard) mesh (counterpart of
repkiller_tpu/dist/sharded.py, whose docstring derives the stages and
their exactness; the output is bit-identical to device.compare for every
mesh shape).

  stage A  body (d, s) joins the k-mers of query window d against the
           index rows that shard s owns (pairwise), or enumerates its
           slice of the canonical index's entries (self), into a
           static-capacity hit block. The union of all bodies' blocks is
           the single-device hit set, each hit once.
  stage B  a data row's hit blocks are brought together (all-gather along
           the shard axis; the canonical self path first regroups its hits
           by destination window with an all-to-all along the data axis),
           so body (d, s) holds window d's complete hit set, which it
           thins and extends window-locally: windows are rounded up to
           lcm(min_hit_dist, gate_stride), so no thinning or gate bucket
           spans two windows.
  stage C  the per-window fragment blocks, in strand order then data
           order, go through one merge_accept. Under a process mesh every
           rank gathers the blocks of every data row first, so every rank
           ends with the full table.

Each stage is a per-body function; the mesh (dist/mesh.py) runs every
body's part up to a collective, the collective, then the next part. The
host checks run after the last stage, on counters that every process
holds, so all ranks of a process mesh raise the same error together.
Inputs are replicated: every process builds the same numpy input.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import extend_strand, merge_strands, revcomp_device
from ..families import cluster_families
from ..index.build import build_index
from ..index.canonical import build_canonical_index
from ..index.shards import (build_canonical_dist, build_sharded_index,
                            build_sharded_index_dist, shard_capacity)
from ..seeds.filter import filter_hits
from ..seeds.join import join_hits
from ..seeds.self_join import join_self_canonical
from ..table import empty
from ..utils import trace
from .mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh


def _window_join(cx_pad: torch.Tensor, idxY, idxX_occ, d: int, win: int,
                 cap_dev: int, cfg: Config):
    """Stage A of body (d, s), pairwise: window d's k-mers (a slice of the
    N-padded X) against shard s's Y rows ``idxY`` (kS, pS, count), X-side
    occurrences counted in shard s's X rows ``idxX_occ`` (kS, count). A
    k-mer the shard does not own searches to an empty run."""
    w0 = d * win
    km, pos, nv = build_index(cx_pad[w0:w0 + win + cfg.k - 1], cfg.k)
    return join_hits(km, pos + w0, nv, *idxY, k=cfg.k, max_occ=cfg.max_occ,
                     capacity=cap_dev, occ_idx=idxX_occ)


def _build_idx(codes: dict, cfg: Config, mesh: Mesh, cap_shard: int):
    """The sharded index of the replicated ``codes`` -> ({body: (kS row,
    pS row, counts)}, {body: blk_over} or None): the distributed build on
    a multi-body mesh, the global-sort build on one body."""
    if mesh.size > 1:
        out = build_sharded_index_dist(codes, cfg.k, cap_shard, mesh,
                                       cfg.shard_slack)
        return ({b: v[:3] for b, v in out.items()},
                {b: v[3] for b, v in out.items()})
    (b, c), = codes.items()
    kS, pS, cnt = build_sharded_index(c, cfg.k, 1, cap_shard)
    return {b: (kS[0], pS[0], cnt)}, None


def _pack_by_window(px, py, hv, n_data: int, win: int, cap_b: int):
    """One body's hit block partitioned by destination window px // win
    into dense (n_data, cap_b) send blocks -> (pxB, pyB, okB int8, largest
    count); the caller raises a shard_slack overflow when that count
    exceeds cap_b. The one-key sort is stable, as ``lax.sort``, so block
    contents match the reference's slot for slot."""
    cap = px.shape[0]
    dest = torch.where(hv, px // win, n_data)
    d_s, perm = torch.sort(dest, stable=True)
    px_s, py_s = px[perm], py[perm]
    b = torch.searchsorted(d_s, torch.arange(n_data + 1, dtype=d_s.dtype,
                                             device=px.device)).to(torch.int32)
    cnt = b[1:] - b[:-1]
    rows = b[:-1, None] + torch.arange(cap_b, dtype=torch.int32, device=px.device)
    ok = rows < b[1:, None]
    idx = rows.clamp(max=cap - 1)
    return (torch.where(ok, px_s[idx], 0), torch.where(ok, py_s[idx], 0),
            ok.to(torch.int8), cnt.max())


def _thin_extend_window(mesh: Mesh, hits: dict, cx: dict, cy_cmp: dict,
                        cfg: Config, strand: int, win_seed_cap: int) -> dict:
    """Stage B: all-gather each data row's hit blocks along the shard axis,
    then thin at ``win_seed_cap`` and run the gated extension window-locally
    -> {body: (frag, valid, n_seeds)}."""
    hx, hy, hv = (mesh.all_gather({b: h[i] for b, h in hits.items()}, SHARD_AXIS)
                  for i in range(3))

    def body(b, x, y, v, c, cc):
        spx, spy, sv, n_seeds = filter_hits(x, y, v, cfg.min_hit_dist,
                                            out_capacity=win_seed_cap)
        frag, fv = extend_strand(spx, spy, sv, n_seeds, c, cc, cfg, strand)
        return frag, fv, n_seeds
    return mesh.map(body, hx, hy, hv, cx, cy_cmp)


def _canon_self_body(ci, cfg: Config, y_len: int, cap_dev: int, blk_e: int,
                     n_shard: int):
    """Stage A of body (d, s), canonical self path on a one-body index
    replicated to every body: body i = d * n_shard + s enumerates entries
    [i * blk_e, (i + 1) * blk_e)."""
    def body(b):
        i = b[0] * n_shard + b[1]
        return join_self_canonical(ci[b], cfg.k, cfg.max_occ, cap_dev, y_len,
                                   entry_slice=(i * blk_e, blk_e))
    return body


def _canon_self_body_dist(ci, cfg: Config, y_len: int, cap_dev: int, blk_e: int):
    """Stage A of body (d, s) on the hash-sharded canonical index: data
    slice d of shard s's entries; partner lookups read the whole shard's
    ``pos_b``. The (shard, slice) pairs partition all entries."""
    def body(b):
        return join_self_canonical(ci[b], cfg.k, cfg.max_occ, cap_dev, y_len,
                                   entry_slice=(b[0] * blk_e, blk_e))
    return body


def _regroup_thin_extend(mesh: Mesh, hits: dict, cx: dict, cy_r: dict,
                         cfg: Config, win: int, cap_b: int, win_seed_cap: int):
    """Shared tail of the canonical self path, per strand: pack each body's
    hits by destination window, all-to-all along the data axis, then stage
    B -> ([{body: (frag, valid, n_seeds)} per strand], the largest send
    block of any body)."""
    outs, cnt_max = [], []
    dev = _first(mesh.devices)
    for strand in _strands(cfg):
        with trace.span("sharded.regroup", device=dev):
            packs = mesh.map(lambda b, h: _pack_by_window(
                *h[strand][:3], mesh.n_data, win, cap_b), hits)
            sent = [mesh.all_to_all({b: p[i] for b, p in packs.items()},
                                    DATA_AXIS) for i in range(3)]
            regrouped = {b: (sent[0][b].reshape(-1), sent[1][b].reshape(-1),
                             sent[2][b].reshape(-1).bool())
                         for b in mesh.bodies}
            cnt_max.append({b: p[3].reshape(1) for b, p in packs.items()})
        with trace.span("sharded.extend", device=dev):
            outs.append(_thin_extend_window(
                mesh, regrouped, cx, cx if strand == 0 else cy_r, cfg, strand,
                win_seed_cap))
    largest = max(int(mesh.gather_counts(c).max()) for c in cnt_max)
    return outs, largest


def _strands(cfg: Config) -> list:
    return [s for s in (0, 1) if "fr"[s] in cfg.strands]


def _self_canonical_sharded(cx: dict, cfg: Config, mesh: Mesh, win: int,
                            cap_dev: int, cap_shard: int):
    """Both strands of a sharded self-comparison from one canonical index:
    built in place on a one-body mesh, hash-sharded by the distributed
    build otherwise -> (per-strand stage-B outputs, {body: hit totals per
    strand}, the index shard counts, [[largest block, its capacity]] of
    the window regroup and of the distributed build)."""
    n_data, n_shard = mesh.n_data, mesh.n_shard
    c0 = next(iter(cx.values()))
    dev = _first(mesh.devices)
    cap_b = shard_capacity(cap_dev, n_data, cfg.shard_slack)
    blk_overs = []
    if mesh.size == 1:
        (b, c), = cx.items()
        with trace.span("sharded.index", device=dev):
            cy_r = mesh.replicate(revcomp_device(c0))
            ci = build_canonical_index(c, cfg.k)
        with trace.span("sharded.hits", device=dev):
            hits = mesh.map(_canon_self_body({b: ci}, cfg, c.shape[0],
                                             cap_dev, ci.pos.shape[0],
                                             n_shard))
        shard_cnt = np.zeros(n_shard, np.int32)
    else:
        with trace.span("sharded.index", device=dev):
            cy_r = mesh.replicate(revcomp_device(c0))
            built = build_canonical_dist(cx, cfg.k, cap_shard, mesh,
                                         cfg.shard_slack)
        with trace.span("sharded.hits", device=dev):
            hits = mesh.map(_canon_self_body_dist(
                {b: v[0] for b, v in built.items()}, cfg, c0.shape[0],
                cap_dev, cap_shard // n_data))
        _, cnt, blk_build = _first(built)
        shard_cnt = cnt.cpu().numpy()
        blk_overs.append(blk_build.tolist())
    outs, largest = _regroup_thin_extend(mesh, hits, cx, cy_r, cfg, win, cap_b,
                                         cfg.seed_cap // n_data)
    blk_overs.insert(0, [largest, cap_b])
    totals = {b: torch.stack([h[s][3] for s in _strands(cfg)])
              for b, h in hits.items()}
    return outs, totals, shard_cnt, blk_overs


def _one_strand_sharded(cx: dict, cx_pad: dict, idxX, cy_cmp: dict,
                        strand: int, cfg: Config, mesh: Mesh, win: int,
                        cap_dev: int, cap_shard: int):
    """Sharded hits and per-window thinning and extension of one strand of
    a pairwise comparison: Y's index (of Y, or of revcomp(Y)) is built
    sharded here -> (stage-B outputs, {body: hit total}, Y's shard counts,
    Y's build blk_over or None). Counters: ``entries`` on the index span
    (Y's positions), ``queries`` on the hits span (the window k-mers
    inside X that this process's bodies join)."""
    dev = _first(mesh.devices)
    with trace.span("sharded.index", device=dev):
        trace.count("entries", _first(cy_cmp).shape[0] - cfg.k + 1)
        idxY, blk_over = _build_idx(cy_cmp, cfg, mesh, cap_shard)
    with trace.span("sharded.hits", device=dev):
        n_pos = _first(cx).shape[0] - cfg.k + 1   # window d: from d * win on
        trace.count("queries", sum(min(win, max(n_pos - b[0] * win, 0))
                                   for b in cx_pad))
        hits = mesh.map(lambda b, c, iy, ix: _window_join(
            c, (iy[0], iy[1], iy[2][b[1]]), (ix[0], ix[2][b[1]]), b[0], win,
            cap_dev, cfg), cx_pad, idxY, idxX)
    with trace.span("sharded.extend", device=dev):
        out = _thin_extend_window(mesh, hits, cx, cy_cmp, cfg, strand,
                                  cfg.seed_cap // mesh.n_data)
    return out, {b: h[3] for b, h in hits.items()}, _first(idxY)[2], blk_over


def _first(per_body: dict):
    """A value that every body holds alike (a global count)."""
    return next(iter(per_body.values()))


def _pairwise_sharded(cx: dict, cy: dict, cx_pad: dict, cfg: Config,
                      mesh: Mesh, win: int, cap_dev: int, cap_shard: int):
    """Both requested strands of a sharded pairwise comparison against X's
    sharded index -> as _self_canonical_sharded. Spans: X's
    "sharded.index" (counter ``entries``), then per strand
    "sharded.revcomp" (strand r's revcomp(Y)) and _one_strand_sharded's."""
    dev = _first(mesh.devices)
    with trace.span("sharded.index", device=dev):
        trace.count("entries", _first(cx).shape[0] - cfg.k + 1)
        idxX, blkX = _build_idx(cx, cfg, mesh, cap_shard)
    shard_cnts = [_first(idxX)[2]]
    blk_overs = [] if blkX is None else [_first(blkX)]
    outs, totals = [], []
    for strand in _strands(cfg):
        if strand == 0:
            cy_cmp = cy
        else:
            with trace.span("sharded.revcomp", device=dev):
                cy_cmp = mesh.replicate(revcomp_device(_first(cy)))
        out, tot, sc, bo = _one_strand_sharded(cx, cx_pad, idxX, cy_cmp, strand,
                                               cfg, mesh, win, cap_dev, cap_shard)
        outs.append(out), totals.append(tot), shard_cnts.append(sc)
        if bo is not None:
            blk_overs.append(_first(bo))
    return (outs, {b: torch.stack([t[b] for t in totals]) for b in mesh.bodies},
            torch.cat(shard_cnts).cpu().numpy(),
            [bo.tolist() for bo in blk_overs] or [[0, 0]])


def _stage_c(mesh: Mesh, outs: list, y_len: int, cfg: Config):
    """Every data row's fragment blocks, strand by strand, on every
    process (all-gather along the data axis), then one merge_accept ->
    (out, n_frags) on this process's first body's device."""
    b0 = mesh.bodies[0]
    frags, valids = [], []
    for out in outs:
        fields = list(out[b0][0])
        full = {f: mesh.all_gather({b: o[0][f] for b, o in out.items()},
                                   DATA_AXIS)[b0] for f in fields}
        frags.append(full)
        valids.append(mesh.all_gather({b: o[1] for b, o in out.items()},
                                      DATA_AXIS)[b0])
    out, _, n_frags = merge_strands(frags, valids, y_len, cfg)
    return out, n_frags


def compare_sharded(codesX: np.ndarray, codesY: Optional[np.ndarray],
                    cfg: Config, mesh: Optional[Mesh] = None, *,
                    device="cuda") -> Dict[str, np.ndarray]:
    """Sharded equivalent of device.compare: the same output on any mesh.
    ``mesh`` defaults to make_mesh(device=device): a process mesh under an
    active process group, else every visible device of type ``device``.

    Raises, in the reference's order and with its messages: hit and seed
    capacity not divisible by the mesh size; then, after the run, index
    shard capacity, per-device hit capacity, shuffle block, per-window
    seed capacity (seed_capacity // n_data) and fragment capacity
    overflow."""
    if mesh is None:
        mesh = make_mesh(device=device)
    n_data, n_shard = mesh.n_data, mesh.n_shard
    n_dev = n_data * n_shard
    if cfg.hit_capacity % n_dev:
        raise ValueError(f"hit_capacity {cfg.hit_capacity} must be divisible "
                         f"by the {n_dev}-device mesh")
    if cfg.seed_cap % n_dev:
        raise ValueError(f"seed_capacity {cfg.seed_cap} must be divisible "
                         f"by the {n_dev}-device mesh")
    cap_dev = cfg.hit_capacity // n_dev

    self_cmp = codesY is None
    cx_np = np.asarray(codesX, np.uint8)
    cy_np = cx_np if self_cmp else np.asarray(codesY, np.uint8)
    if cx_np.shape[0] < cfg.k or cy_np.shape[0] < cfg.k:
        return empty()

    # the window rounds UP to the thinning and gating bucket quantum
    n_pos = cx_np.shape[0] - cfg.k + 1
    win = -(-n_pos // n_data)
    quantum = int(np.lcm(cfg.min_hit_dist, max(cfg.gate_stride, 1)))
    win = -(-win // quantum) * quantum
    cx_pad_np = np.full(n_data * win + cfg.k - 1, 4, np.uint8)
    cx_pad_np[: cx_np.shape[0]] = cx_np
    n_pos_max = max(cx_np.shape[0], cy_np.shape[0]) - cfg.k + 1
    cap_shard = shard_capacity(n_pos_max, n_shard, cfg.shard_slack)
    # the canonical self path slices each shard's rows across the data axis
    cap_shard = -(-cap_shard // n_data) * n_data

    dev = _first(mesh.devices)
    with trace.span("compare", device=dev):
        cx = mesh.replicate(cx_np)
        if self_cmp:
            outs, totals, shard_cnts, blk_over = _self_canonical_sharded(
                cx, cfg, mesh, win, cap_dev, cap_shard)
        else:
            outs, totals, shard_cnts, blk_over = _pairwise_sharded(
                cx, mesh.replicate(cy_np), mesh.replicate(cx_pad_np), cfg,
                mesh, win, cap_dev, cap_shard)
        with trace.span("sharded.merge", device=dev):
            out, n_frags = _stage_c(mesh, outs, cy_np.shape[0], cfg)
        with trace.span("sharded.copy_out", device=dev):
            # every counter on every process before any check raises
            n_str = len(outs)
            counts = mesh.gather_counts({
                b: torch.cat([totals[b], torch.stack([o[b][2] for o in outs])]
                             ).to(torch.int64) for b in mesh.bodies})
            totals, nseeds = counts[:, :n_str], counts[:, n_str:]
            trace.count("hits", int(totals.sum()))
            trace.count("seeds", int(nseeds.sum()))
            blk_over = np.asarray(blk_over)
            win_seed_cap = cfg.seed_cap // n_data
            if (shard_cnts > cap_shard).any():
                raise ValueError(
                    f"index shard capacity {cap_shard} overflow (max shard "
                    f"{int(shard_cnts.max())} entries — skewed k-mer "
                    "prefixes); raise Config.shard_slack")
            # hit-capacity overflow is checked before block skew: when the
            # expansion itself overflowed, the skewed send blocks are a
            # consequence
            if (totals > cap_dev).any():
                raise ValueError(
                    f"per-device hit capacity {cap_dev} overflow (max block "
                    f"{int(totals.max())}); raise Config.hit_capacity")
            if (blk_over[:, 0] > blk_over[:, 1]).any():
                raise ValueError(
                    f"shuffle block overflow (max block "
                    f"{int(blk_over[:, 0].max())} entries > cap "
                    f"{int(blk_over[:, 1].max())} — chunk-local k-mer prefix "
                    "or window-destination skew); raise Config.shard_slack")
            if (nseeds > win_seed_cap).any():
                raise ValueError(
                    f"per-window seed capacity {win_seed_cap} (= "
                    f"seed_capacity {cfg.seed_cap} / {n_data} windows) "
                    f"overflow: max window seed count {int(nseeds.max())}; "
                    "raise Config.seed_capacity")
            n = int(n_frags)
            if n > 0 and n == out["xStart"].shape[0]:
                raise ValueError("frag capacity overflow; raise "
                                 "Config.seed_capacity / Config.hit_capacity")
            trace.count("fragments", n)
            frag = {f: v[:n].cpu().numpy() for f, v in out.items()}
        frag["group"] = cluster_families(frag, cfg, self_cmp, device=dev)
    return frag
