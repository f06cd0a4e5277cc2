"""Pipeline configuration: the port's copy of repkiller_tpu/config.py, with
the same fields, defaults and checks.

Single source of truth for every tunable in the repeat-detection engine.
Mirrors the reference tool's CLI flags (repkiller / GECKO family; the flag
surface is reconstructed in SURVEY.md §2.1/§5 and BASELINE.json).

Every stage — oracle (numpy), single-chip device pipeline, and the
sharded multi-host pipeline — consumes the same ``Config`` so outputs are
bit-identical across backends (BASELINE.json north-star requirement).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # ---- seeding (SURVEY.md §2.2: k-mer index build) ----
    k: int = 12                  # seed k-mer size; 1..16 (2 bits/base in uint32)
    max_occ: int = 64            # skip k-mers occurring more often (hyper-repeat cap)

    # ---- hit filtering (SURVEY.md §2.2: filterHits equivalent) ----
    min_hit_dist: int = 32       # on one diagonal, drop hits closer than this to
                                 # the previously kept hit (posX distance)

    # ---- seed chaining / coverage gating (SURVEY.md §1 L3 "chaining";
    # GECKO FragHits skips hits covered by the previous fragment on the
    # same diagonal — this is the deterministic, shard/window-invariant
    # TPU formulation of that skip) ----
    gate_stride: int = 2048      # bucket width (bp of posX) for coverage
                                 # gating: the FIRST seed of every
                                 # (diagonal, px // gate_stride) bucket is
                                 # an ANCHOR and always extends; a later
                                 # seed of the same bucket is skipped iff
                                 # its k-mer window lies inside its
                                 # anchor's fragment x-extent (the
                                 # fragment already covers it). 0 = off
                                 # (every thinned seed extends).
                                 # Bucket membership depends only on
                                 # (diag, px), so gating is invariant to
                                 # sharding and to window splits that are
                                 # multiples of gate_stride.

    # ---- extension (SURVEY.md §2.2: FragHits equivalent) ----
    extend_mode: str = "ungapped"  # "ungapped" (x-drop) | "banded" (affine-gap DP)
    match: int = 4               # match score (GECKO-style +4)
    mismatch: int = -4           # mismatch score (GECKO-style -4)
    x_drop: int = 40             # stop when score falls this far below running max
    max_extend: int = 2048       # hard cap on per-side extension length (static shape)
    # banded affine-gap DP (BASELINE.json: "banded affine-gap DP kernel")
    band: int = 15               # band half-width around the seed diagonal;
                                 # default 15 -> width W = 2*band+1 = 31,
                                 # which fills exactly four (8,128) VPU
                                 # registers per DP row on TPU (band 16
                                 # would pad W=33 to 40 sublanes, ~25%
                                 # wasted vector work per row)
    gap_open: int = 8            # positive penalty; a gap of length g costs
    gap_extend: int = 2          #   gap_open + g * gap_extend (Gotoh affine)
    banded_impl: str = "auto"    # "auto" | "xla" | "pallas" — banded kernel
                                 # choice; auto = pallas on TPU, xla elsewhere
                                 # (both bit-identical; tests assert it)
    ungapped_impl: str = "auto"  # same choice for the ungapped x-drop kernel

    # ---- fragment acceptance ----
    min_len: int = 40            # min fragment length (bp on X)
    min_identity: float = 0.60   # min fraction of identities over fragment length

    # ---- repeat-family clustering (repkiller proper, SURVEY.md §2.1) ----
    proximity: int = 32          # intervals within this many bp are "overlapping"
    len_ratio: float = 0.5       # min(short/long) fragment-length ratio to link; 0 = off
    min_family: int = 2          # families with fewer repeat COPIES are not
                                 # repeats (a self-comparison fragment = 2 copies)

    # ---- strands ----
    strands: str = "f"           # "f", "r", or "fr"

    # ---- capacities (static shapes for XLA; overflow is detected, not silent) ----
    hit_capacity: int = 1 << 20      # max seed hits kept per (window, strand)
    seed_capacity: int = 0           # max THINNED seeds per (window, strand);
                                     # 0 = same as hit_capacity. Thinning
                                     # keeps one hit per (diag, min_hit_dist
                                     # bucket), so the surviving count is
                                     # usually well under the hit count — a
                                     # tighter static bound here shrinks every
                                     # capacity-sized sort/gather in the
                                     # extension stage (the fragment arrays
                                     # inherit this bound: one fragment per
                                     # surviving seed). Overflow raises, never
                                     # truncates.

    shard_slack: float = 1.5         # physically sharded index (dist/sharded,
                                     # index/shards.py): per-shard row capacity
                                     # = slack * n_kmers / n_shards. Hash-prefix
                                     # ownership is only as balanced as the
                                     # genome's k-mer spectrum; overflow raises
                                     # with instructions to raise this.

    # ---- streaming / sharding (SURVEY.md §2.3) ----
    window: int = 1 << 22        # query window length (bp) for data-parallel
                                 # streaming. No overlap is needed: windows
                                 # partition seed START positions and every
                                 # window joins/extends against the full
                                 # HBM-resident index and sequences
                                 # (dist/windows.py), so no fragment can be
                                 # lost at a boundary. The streamed backend
                                 # rounds the window to a multiple of both
                                 # min_hit_dist and gate_stride so thinning
                                 # buckets and gate buckets never span a
                                 # window boundary (output invariance).

    def __post_init__(self):
        if not (1 <= self.k <= 16):
            raise ValueError(f"k must be in [1,16], got {self.k}")
        if self.gate_stride < 0:
            raise ValueError(f"gate_stride must be >= 0, got {self.gate_stride}")
        if self.min_hit_dist < 1:
            raise ValueError(f"min_hit_dist must be >= 1, got {self.min_hit_dist}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.extend_mode not in ("ungapped", "banded"):
            raise ValueError(f"unknown extend_mode {self.extend_mode!r}")
        if self.banded_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown banded_impl {self.banded_impl!r}")
        if self.ungapped_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown ungapped_impl {self.ungapped_impl!r}")
        if self.strands not in ("f", "r", "fr"):
            raise ValueError(f"strands must be 'f','r','fr', got {self.strands!r}")
        if self.gap_open < 0 or self.gap_extend < 0:
            raise ValueError("gap penalties are stored positive")
        if self.shard_slack < 1.0:
            raise ValueError(
                f"shard_slack must be >= 1.0, got {self.shard_slack}")
        if self.seed_capacity < 0:
            raise ValueError(
                f"seed_capacity must be >= 0 (0 = hit_capacity), "
                f"got {self.seed_capacity}")
        if self.seed_capacity > self.hit_capacity:
            raise ValueError(
                f"seed_capacity {self.seed_capacity} exceeds hit_capacity "
                f"{self.hit_capacity} (seeds are thinned hits)")

    @property
    def seed_cap(self) -> int:
        """Effective thinned-seed capacity (0 sentinel -> hit_capacity)."""
        return self.seed_capacity or self.hit_capacity

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
