"""Job inputs from the seed: a pool of synthetic genomes with planted
repeat families, written as FASTA files.

``plant`` is a frozen copy of the program's ``utils/synth.plant`` (itself
the JAX package's generator), so the yardstick does not move when the
program's copy does: a seeded uniform background with planted families of
exact, diverged and inverted copies at non-overlapping positions.

A pairwise configuration (``"comparison": "pair"``) pools pairs of
strains: strain A is planted as above, and strain B is derived from A by
``derive_strain``, a frozen copy of ``benchmarks/run_config3.py``'s
divergence profile (SNPs, a segment swap, an inserted block).
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


def derive_strain(a: np.ndarray, profile: dict, seed: int) -> np.ndarray:
    """Strain B of a pair from strain A's codes: substitutions at
    ``snp_rate``, A's first two quarters swapped (``swap`` "quarter"), and
    ``insertion_bp`` random bases inserted at A's midpoint."""
    if profile["swap"] != "quarter":
        raise ValueError(f"unknown swap {profile['swap']!r}")
    size = a.shape[0]
    rng = np.random.default_rng(seed)
    b = a.copy()
    snp = rng.random(size) < profile["snp_rate"]
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    q = size // 4
    b = np.concatenate([b[q : 2 * q], b[:q], b[2 * q :]])
    ins = rng.integers(0, 4, profile["insertion_bp"]).astype(np.uint8)
    return np.concatenate([b[: size // 2], ins, b[size // 2 :]])


def _write(path: str, records) -> int:
    """Write ``records`` as FASTA at ``path`` -> their bases."""
    with open(path, "wb") as f:
        f.write(fasta_bytes(records))
    return sum(c.shape[0] for _, c in records)


def make_pool(config: dict, seed: int, directory: str) -> List[dict]:
    """The configuration's pool of genomes for ``seed``, each written as a
    FASTA file under ``directory`` -> [{"path", "bp"}] (bp: input bases).
    A pairwise configuration's entries are pairs: {"path" (strain A),
    "path_y" (strain B), "bp" (both)}."""
    pool = []
    for i in range(config["pool"]):
        records = [(rec["name"], plant(rec["length"], config["families"],
                                       genome_seed(seed, i, r)))
                   for r, rec in enumerate(config["records"])]
        if config["comparison"] == "pair":
            if len(records) != 1:
                raise ValueError("strain B derives from a single record")
            b = config["strain_b"]
            y = [(b["name"], derive_strain(records[0][1], b,
                                           genome_seed(seed, i, 1)))]
            path = os.path.join(directory, f"pair{i}_a.fa")
            path_y = os.path.join(directory, f"pair{i}_b.fa")
            pool.append({"path": path, "path_y": path_y,
                         "bp": _write(path, records) + _write(path_y, y)})
            continue
        path = os.path.join(directory, f"genome{i}.fa")
        pool.append({"path": path, "bp": _write(path, records)})
    return pool
