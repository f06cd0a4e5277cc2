"""Plain reference of a genome job's input parse and output files.

The file formats are the program's (GECKO-shaped fragment CSV, family
summary CSV, BED of repeat intervals, hard-masked FASTA), of a
self-comparison or of a pairwise one, rendered here
from the reference's own fragment table in plain Python and numpy; the
program's files are judged against these bytes. Nothing of the program is
imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

NCODE = 4
SPACER = 32                    # N codes between records
MASK_LINE = 70                 # bases a line of the masked FASTA

_LUT = np.full(256, NCODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[ord(chr(_b).lower())] = _i


@dataclass
class Genome:
    codes: np.ndarray          # records joined by SPACER N codes
    names: List[str]
    offsets: np.ndarray        # int64, start of each record in codes
    lengths: np.ndarray        # int64


def parse_fasta(data: bytes) -> Genome:
    """FASTA bytes -> records joined by N spacers; A/C/G/T (either case)
    are codes 0-3, anything else 4; a sequence before any header is a
    record named seq0."""
    names, chunks, offsets, lengths, cur = [], [], [], [], []
    pos = 0

    def flush():
        nonlocal pos
        if not names:
            return
        cod = _LUT[np.frombuffer(b"".join(cur), dtype=np.uint8)]
        if chunks:
            chunks.append(np.full(SPACER, NCODE, np.uint8))
            pos += SPACER
        offsets.append(pos)
        lengths.append(cod.shape[0])
        chunks.append(cod)
        pos += cod.shape[0]
        cur.clear()

    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            flush()
            names.append(line[1:].split()[0].decode("ascii")
                         if len(line) > 1 else f"seq{len(names)}")
        else:
            if not names:
                names.append("seq0")
            cur.append(line)
    flush()
    codes = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return Genome(codes, names, np.asarray(offsets, np.int64),
                  np.asarray(lengths, np.int64))


def _intervals(frag, self_cmp: bool):
    n = frag["xStart"].shape[0]
    ys = np.minimum(frag["yStart"], frag["yEnd"])
    ye = np.maximum(frag["yStart"], frag["yEnd"])
    space = np.concatenate([np.zeros(n, np.int64),
                            np.zeros(n, np.int64) if self_cmp
                            else np.ones(n, np.int64)])
    return (space, np.concatenate([frag["xStart"], ys]).astype(np.int64),
            np.concatenate([frag["xEnd"], ye]).astype(np.int64))


def repeat_intervals(frag, min_family: int, self_cmp: bool = True):
    """{space: int64[n, 2]} inclusive: the union of the intervals of every
    fragment whose family has at least ``min_family`` copies (a
    self-comparison fragment is two copies), overlapping or adjacent
    intervals joined."""
    out: Dict[int, np.ndarray] = {}
    group = frag["group"]
    if group.shape[0] == 0:
        return out
    fams, inv = np.unique(group, return_inverse=True)
    copies = (2 if self_cmp else 1) * np.bincount(inv, minlength=fams.shape[0])
    sel = {k: v[copies[inv] >= min_family] for k, v in frag.items()}
    space, start, end = _intervals(sel, self_cmp)
    for sp in np.unique(space):
        m = space == sp
        o = np.lexsort((end[m], start[m]))
        s, e = start[m][o], end[m][o]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.shape[0], bool)
        new[1:] = s[1:] > reach[:-1] + 1
        first = np.nonzero(new)[0]
        last = np.append(first[1:], s.shape[0]) - 1
        out[int(sp)] = np.stack([s[first], reach[last]], 1)
    return out


def family_csv(frag) -> bytes:
    group = frag["group"]
    lines = ["family,n_frags,max_score,total_len\n"]
    if group.shape[0]:
        fams, inv = np.unique(group, return_inverse=True)
        nf = fams.shape[0]
        n_frags = np.bincount(inv, minlength=nf)
        max_score = np.zeros(nf, np.int64)
        np.maximum.at(max_score, inv, frag["score"].astype(np.int64))
        total = np.zeros(nf, np.int64)
        np.add.at(total, inv, frag["length"].astype(np.int64))
        lines += ["%d,%d,%d,%d\n" % row for row in
                  zip(fams.tolist(), n_frags.tolist(), max_score.tolist(),
                      total.tolist())]
    return "".join(lines).encode("ascii")


def _records(gg: Genome) -> str:
    return " ".join("%s:%d:%d" % (nm, o, ln) for nm, o, ln in
                    zip(gg.names, gg.offsets.tolist(), gg.lengths.tolist()))


def frags_csv(frag, g: Genome, y: Optional[Genome] = None) -> bytes:
    """The fragment CSV of a self-comparison, or of X (``g``) against Y
    (``y``): 1-based inclusive coordinates in the joined space; the family
    id in the block column; record ids in seqX/seqY when there are several
    records, else 0, and 1 in seqY of a pairwise run."""
    n = int(frag["xStart"].shape[0])
    gy = g if y is None else y
    multi = len(g.names) > 1
    head = ["All by-Identity Fragments (repkiller-tpu)\n",
            "SeqX name : %s\n" % g.names[0],
            "SeqX length : %d\n" % g.codes.shape[0],
            "SeqY name : %s\n" % gy.names[0],
            "SeqY length : %d\n" % gy.codes.shape[0]]
    if multi:
        head += ["Records X : %s\n" % _records(g),
                 "Records Y : %s\n" % _records(gy)]
    elif len(gy.names) > 1:
        head += ["Records Y : %s\n" % _records(gy)]
    head += ["Total hits (seeds) : 0\n", "Total fragments : %d\n" % n,
             "=" * 56 + "\n",
             "Type,xStart,yStart,xEnd,yEnd,strand,block,length,score,ident,"
             "similarity,identity,seqX,seqY\n"]

    def rec_ids(gg, a, b, single):
        if len(gg.names) < 2:
            return np.full(n, single, np.int64)
        left = np.minimum(a, b)
        return np.maximum(np.searchsorted(gg.offsets, left, side="right") - 1,
                          0)

    rx = rec_ids(g, frag["xStart"], frag["xEnd"], 0)
    ry = rec_ids(gy, frag["yStart"], frag["yEnd"], 0 if y is None else 1)
    cols = [frag[f].astype(np.int64).tolist() for f in
            ("xStart", "yStart", "xEnd", "yEnd", "strand", "group", "length",
             "score", "idents")]
    rows = []
    for xs, ys, xe, ye, st, gr, ln, sc, idn, a, b in zip(
            *cols, rx.tolist(), ry.tolist()):
        sim = 100.0 * idn / ln if ln else 0.0
        rows.append("Frag,%d,%d,%d,%d,%s,%d,%d,%d,%d,%.2f,%.2f,%d,%d\n" % (
            xs + 1, ys + 1, xe + 1, ye + 1, "f" if st == 0 else "r", gr, ln,
            sc, idn, sim, sim, a, b))
    return ("".join(head) + "".join(rows)).encode("ascii")


def bed(iv: Dict[int, np.ndarray], g: Genome,
        y: Optional[Genome] = None) -> bytes:
    """Repeat intervals as BED rows, one per record they overlap, in
    record-local half-open coordinates; parts on spacers are dropped.
    Those of X (space 0) on ``g``'s records, then, in a pairwise run,
    those of Y (space 1) on ``y``'s."""
    rows = []
    for space, gg in ((0, g), (1, y)):
        if gg is None:
            continue
        for s, e in iv.get(space, np.zeros((0, 2), np.int64)).tolist():
            r0 = max(0, int(np.searchsorted(gg.offsets, s, side="right")) - 1)
            r1 = max(0, int(np.searchsorted(gg.offsets, e, side="right")) - 1)
            for r in range(r0, r1 + 1):
                o, ln = int(gg.offsets[r]), int(gg.lengths[r])
                rs, re = max(s, o), min(e, o + ln - 1)
                if rs <= re:
                    rows.append("%s\t%d\t%d\n" % (gg.names[r], rs - o,
                                                  re - o + 1))
    return "".join(rows).encode("ascii")


def masked_fasta(iv: Dict[int, np.ndarray], g: Genome) -> bytes:
    """Each record with the repeat intervals of X set to N, 70 bases a
    line, headed ``>name masked``."""
    L = g.codes.shape[0]
    cover = np.zeros(L + 1, np.int64)
    ivx = iv.get(0, np.zeros((0, 2), np.int64))
    np.add.at(cover, ivx[:, 0], 1)
    np.add.at(cover, np.minimum(ivx[:, 1] + 1, L), -1)
    masked = np.where(np.cumsum(cover[:L]) > 0, NCODE, g.codes).astype(np.uint8)
    text = np.frombuffer(b"ACGTN", np.uint8)[masked]
    out = []
    for name, o, ln in zip(g.names, g.offsets.tolist(), g.lengths.tolist()):
        body = text[o : o + ln].tobytes()
        lines = b"\n".join(body[i : i + MASK_LINE]
                           for i in range(0, len(body), MASK_LINE))
        out.append(b">%s masked\n%s\n" % (name.encode("ascii"), lines))
    return b"".join(out)


def render(frag, g: Genome, min_family: int, mask: bool,
           y: Optional[Genome] = None) -> Dict[str, bytes]:
    """Every file of a job, by suffix; ``y``: the second genome of a
    pairwise job (the masked FASTA is X's)."""
    iv = repeat_intervals(frag, min_family, self_cmp=y is None)
    files = {"frags.csv": frags_csv(frag, g, y),
             "families.csv": family_csv(frag), "repeats.bed": bed(iv, g, y)}
    if mask:
        files["masked.fasta"] = masked_fasta(iv, g)
    return files
