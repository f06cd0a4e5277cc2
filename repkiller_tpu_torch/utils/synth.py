"""Synthetic genomes with planted repeats (SURVEY.md §4.3 golden tests); the
port's copy of repkiller_tpu/utils/synth.py, for chip_smoke.py and the tests.

No network in this environment, so test/bench genomes are generated:
seeded random background + planted repeat families (exact tandem copies,
diverged copies, inverted repeats) whose expected structure is known.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..io import codec


@dataclass
class PlantedRepeat:
    positions: List[int]          # start of each copy (original-strand coords)
    length: int
    inverted: List[bool]          # per copy
    divergence: float


@dataclass
class SynthGenome:
    codes: np.ndarray
    repeats: List[PlantedRepeat] = field(default_factory=list)


def random_codes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def mutate(unit: np.ndarray, divergence: float, rng) -> np.ndarray:
    """Substitution-only divergence (keeps coordinates exact for goldens)."""
    out = unit.copy()
    if divergence > 0:
        m = rng.random(unit.shape[0]) < divergence
        out[m] = (out[m] + rng.integers(1, 4, size=int(m.sum()), dtype=np.uint8)) % 4
    return out


def plant(
    length: int,
    families: List[Tuple[int, int, float, int]],  # (unit_len, n_copies, divergence, n_inverted)
    seed: int = 0,
) -> SynthGenome:
    """Random genome of `length` bp with planted repeat families.

    Copies are placed at evenly spread, non-overlapping offsets, deterministic
    from the seed. Inverted copies are reverse-complemented.
    """
    rng = np.random.default_rng(seed)
    g = random_codes(length, seed + 1)
    placed: List[Tuple[int, int]] = []
    repeats: List[PlantedRepeat] = []

    def overlaps(s, l):
        return any(s < pe and ps < s + l for ps, pe in placed)

    for fam_i, (ulen, ncopies, div, ninv) in enumerate(families):
        unit = random_codes(ulen, seed + 100 + fam_i)
        pos, inv = [], []
        tries = 0
        while len(pos) < ncopies and tries < 10000:
            s = int(rng.integers(0, length - ulen))
            tries += 1
            if overlaps(s, ulen):
                continue
            copy = mutate(unit, div if pos else 0.0, rng)  # first copy exact
            if len(pos) >= ncopies - ninv:
                copy = codec.revcomp_codes(copy)
                inv.append(True)
            else:
                inv.append(False)
            g[s : s + ulen] = copy
            placed.append((s, s + ulen))
            pos.append(s)
        repeats.append(PlantedRepeat(pos, ulen, inv, div))
    return SynthGenome(codes=g, repeats=repeats)
