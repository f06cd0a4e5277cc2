"""Job inputs from the seed: a pool of synthetic genomes with planted
repeat families, written as FASTA files.

``plant`` is a frozen copy of the program's ``utils/synth.plant`` (itself
the JAX package's generator), so the yardstick does not move when the
program's copy does: a seeded uniform background with planted families of
exact, diverged and inverted copies at non-overlapping positions.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

LINE = 80                      # bases per FASTA line


def random_codes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1].copy()


def mutate(unit: np.ndarray, divergence: float, rng) -> np.ndarray:
    """Substitution-only divergence."""
    out = unit.copy()
    if divergence > 0:
        m = rng.random(unit.shape[0]) < divergence
        out[m] = (out[m] + rng.integers(1, 4, size=int(m.sum()),
                                        dtype=np.uint8)) % 4
    return out


def plant(length: int, families: Sequence[Tuple[int, int, float, int]],
          seed: int) -> np.ndarray:
    """Random genome of ``length`` bp with planted repeat families, each
    (unit_len, n_copies, divergence, n_inverted); the first copy of a
    family is exact, its last ``n_inverted`` copies reverse-complemented."""
    rng = np.random.default_rng(seed)
    g = random_codes(length, seed + 1)
    placed: List[Tuple[int, int]] = []

    def overlaps(s, l):
        return any(s < pe and ps < s + l for ps, pe in placed)

    for fam_i, (ulen, ncopies, div, ninv) in enumerate(families):
        unit = random_codes(ulen, seed + 100 + fam_i)
        n_placed, tries = 0, 0
        while n_placed < ncopies and tries < 10000:
            s = int(rng.integers(0, length - ulen))
            tries += 1
            if overlaps(s, ulen):
                continue
            copy = mutate(unit, div if n_placed else 0.0, rng)
            if n_placed >= ncopies - ninv:
                copy = revcomp(copy)
            g[s : s + ulen] = copy
            placed.append((s, s + ulen))
            n_placed += 1
    return g


def genome_seed(seed: int, genome: int, record: int) -> int:
    """A 32-bit generator seed for one record of one pool genome."""
    ss = np.random.SeedSequence([int(seed), genome, record])
    return int(ss.generate_state(1, np.uint32)[0])


def fasta_bytes(records: Sequence[Tuple[str, np.ndarray]]) -> bytes:
    """FASTA text of (name, codes) records, ``LINE`` bases a line."""
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    out = []
    for name, codes in records:
        text = lut[codes]
        n = text.shape[0]
        full = n // LINE * LINE
        body = np.empty((n // LINE, LINE + 1), np.uint8)
        body[:, :LINE] = text[:full].reshape(-1, LINE)
        body[:, LINE] = ord("\n")
        out.append(b">" + name.encode("ascii") + b"\n")
        out.append(body.tobytes())
        if n > full:
            out.append(text[full:].tobytes() + b"\n")
    return b"".join(out)


def make_pool(config: dict, seed: int, directory: str) -> List[dict]:
    """The configuration's pool of genomes for ``seed``, each written as a
    FASTA file under ``directory`` -> [{"path", "bp"}] (bp: input bases)."""
    pool = []
    for i in range(config["pool"]):
        records = [(rec["name"], plant(rec["length"], config["families"],
                                       genome_seed(seed, i, r)))
                   for r, rec in enumerate(config["records"])]
        path = os.path.join(directory, f"genome{i}.fa")
        with open(path, "wb") as f:
            f.write(fasta_bytes(records))
        pool.append({"path": path,
                     "bp": sum(c.shape[0] for _, c in records)})
    return pool
