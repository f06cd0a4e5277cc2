"""Fragment table CSV writer/reader (SURVEY.md §1 L5, §2.1 "Writers"); the
port's copy of repkiller_tpu/report/csv_writer.py. Every table is written
by the native C++ writer (io/native.py) when its library is available;
the Python rows below give the same bytes without it.

The GECKO/repkiller ecosystem exchanges fragments as a CSV with a header
of sequence metadata followed by one `Frag,...` row per fragment
(SURVEY.md §2.1 "CSV loader" — the reference mount was empty, so the
dialect below is GECKO-shaped but defined here as this framework's
canonical format; the reader accepts it back, which gives the standalone
"repkiller proper" entry point: cluster a pre-existing fragment table).

Columns (1-based inclusive coordinates on the original strands; reverse-
strand fragments have yStart > yEnd, the GECKO convention):

  Frag,xStart,yStart,xEnd,yEnd,strand,block,length,score,ident,similarity,identity,seqX,seqY
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional, TextIO, Union

import numpy as np

from ..io import native
from ..utils import trace

FRAG_COLUMNS = (
    "xStart", "yStart", "xEnd", "yEnd", "strand", "block", "length",
    "score", "ident", "similarity", "identity", "seqX", "seqY",
)


def _records_line(axis: str, seqs) -> str:
    """`Records X : name:offset:length ...` — the concatenated-space map
    for multi-record SeqSets, so a consumer can resolve the per-row seqX/
    seqY record ids back to record-local coordinates."""
    parts = ["%s:%d:%d" % (seqs.names[r], int(seqs.offsets[r]),
                           int(seqs.lengths[r]))
             for r in range(len(seqs.names))]
    return "Records %s : %s\n" % (axis, " ".join(parts))


def _render_header(n: int, x_name: str, y_name: Optional[str],
                   x_len: int, y_len: int, total_hits: int,
                   x_seqs=None, y_seqs=None, coords: str = "concat") -> str:
    self_cmp = y_name is None
    rec = ""
    if x_seqs is not None and x_seqs.names and len(x_seqs.names) > 1:
        rec += _records_line("X", x_seqs)
        rec += _records_line("Y", x_seqs if self_cmp else y_seqs) \
            if self_cmp or (y_seqs is not None and y_seqs.names) else ""
    elif (not self_cmp and y_seqs is not None and y_seqs.names
          and len(y_seqs.names) > 1):
        rec += _records_line("Y", y_seqs)
    if coords == "record":
        rec += "Coords : record\n"
    return (
        "All by-Identity Fragments (repkiller-tpu)\n"
        "SeqX name : %s\n" % x_name
        + "SeqX length : %d\n" % x_len
        + "SeqY name : %s\n" % (x_name if self_cmp else y_name)
        + "SeqY length : %d\n" % (x_len if self_cmp else y_len)
        + rec
        + "Total hits (seeds) : %d\n" % total_hits
        + "Total fragments : %d\n" % n
        + "========================================================\n"
        + "Type," + ",".join(FRAG_COLUMNS) + "\n")


def count_bytes(dst) -> None:
    """The size of a path destination, once written, as the innermost
    trace span's ``bytes``; a stream counts nothing."""
    if isinstance(dst, str):
        trace.count("bytes", os.path.getsize(dst))


@trace.traced("report.csv")
def write_frags_csv(
    frag: Dict[str, np.ndarray],
    dst: Union[str, TextIO],
    x_name: str = "seqX",
    y_name: Optional[str] = None,
    x_len: int = 0,
    y_len: int = 0,
    total_hits: int = 0,
    x_seqs=None,
    y_seqs=None,
    coords: str = "concat",
) -> None:
    """Write the canonical fragment dict (+ optional "group" column as the
    `block` field) to CSV. Coordinates are stored 1-based inclusive in the
    CONCATENATED space by default (round-trip-safe through
    read_frags_csv).

    With multi-record x_seqs/y_seqs (SeqSet), the seqX/seqY columns carry
    each fragment's RECORD id (record of its leftmost base) and the
    header gains `Records X/Y : name:offset:length ...` lines — so a
    consumer can tell which chromosome a fragment is on and recover
    record-local coordinates (the config #4 chr2L+2R shape).

    coords="record" (the per-chromosome dialect a GECKO consumer expects)
    writes each row's coordinates RELATIVE to its
    record's start (still 1-based inclusive) and adds a `Coords : record`
    header line; read_frags_csv uses that line plus the Records map and
    the per-row record ids to restore concatenated space, so the round
    trip stays exact. A fragment is attributed to the record of its
    leftmost base (fragments cannot span the inter-record N spacer unless
    the spacer is shorter than an x-drop bridge — the reader restores
    concat space exactly either way).

    Every table, to a path or a text stream, goes through the native C++
    writer when its library is available (the per-row record ids and
    record-local coordinates computed here in numpy); the Python rows
    give the same bytes without it. Each call is a "report.csv" trace
    span that counts the ``rows``, whether the ``native`` writer ran (1)
    or not (0), the ``threads`` that formatted rows and, for a path, the
    ``bytes`` written."""
    if coords not in ("concat", "record"):
        raise ValueError(f"coords must be 'concat' or 'record', got {coords!r}")
    n = int(frag["xStart"].shape[0])
    trace.count("rows", n)
    self_cmp = y_name is None
    header = _render_header(n, x_name, y_name, x_len, y_len, total_hits,
                            x_seqs=x_seqs, y_seqs=y_seqs, coords=coords)
    ys_set = x_seqs if self_cmp else y_seqs
    rx = _rec_ids(x_seqs, frag["xStart"], frag["xEnd"])
    ry = _rec_ids(ys_set, frag["yStart"], frag["yEnd"])
    cols = dict(frag)
    if coords == "record":         # a single-record side keeps its coordinates
        for rec, seqs, ends in ((rx, x_seqs, ("xStart", "xEnd")),
                                (ry, ys_set, ("yStart", "yEnd"))):
            if rec is not None:
                off = np.asarray(seqs.offsets)[rec]
                for f in ends:
                    cols[f] = np.asarray(frag[f]) - off
    use_native = native.available()
    trace.count("native", int(use_native))
    threads = 1
    if use_native:
        threads = native.write_frags_csv(dst, header, cols, self_cmp, rx, ry)
    elif isinstance(dst, str):
        with open(dst, "w") as f:
            _write_rows(f, header, cols, rx, ry, self_cmp)
    else:
        _write_rows(dst, header, cols, rx, ry, self_cmp)
    trace.count("threads", threads)
    count_bytes(dst)


def _rec_ids(seqs, a, b) -> Optional[np.ndarray]:
    """Each row's record id (the record of its leftmost base) on a multi-
    record side; None on a single-record one."""
    if seqs is None or not seqs.names or len(seqs.names) < 2:
        return None
    left = np.minimum(np.asarray(a), np.asarray(b))
    offs = np.asarray(seqs.offsets)
    return np.maximum(np.searchsorted(offs, left, side="right") - 1, 0)


def _write_rows(f: TextIO, header: str, frag: Dict[str, np.ndarray],
                rx: Optional[np.ndarray], ry: Optional[np.ndarray],
                self_cmp: bool) -> None:
    """The header and the Python rows, where the native library is
    unavailable: the bytes the native writer gives."""
    f.write(header)
    group = frag.get("group")
    score = frag["score"]
    length = frag["length"]
    idents = frag["idents"]
    strand = frag["strand"]
    xs, ys = frag["xStart"], frag["yStart"]
    xe, ye = frag["xEnd"], frag["yEnd"]
    for i in range(int(xs.shape[0])):
        ln = int(length[i])
        idn = int(idents[i])
        sim = 100.0 * idn / ln if ln else 0.0
        f.write(
            "Frag,%d,%d,%d,%d,%s,%d,%d,%d,%d,%.2f,%.2f,%d,%d\n"
            % (
                int(xs[i]) + 1, int(ys[i]) + 1, int(xe[i]) + 1, int(ye[i]) + 1,
                "f" if int(strand[i]) == 0 else "r",
                int(group[i]) if group is not None else 0,
                ln, int(score[i]), idn, sim, sim,
                int(rx[i]) if rx is not None else 0,
                int(ry[i]) if ry is not None
                else (0 if self_cmp else 1),
            )
        )


def read_frags_csv(src: Union[str, TextIO, bytes]) -> Dict[str, np.ndarray]:
    """Parse a fragments CSV back into the canonical fragment dict
    (0-based inclusive coords; `block` column -> "group")."""
    if isinstance(src, str) and "\n" not in src:
        with open(src) as f:
            text = f.read()
    elif isinstance(src, bytes):
        text = src.decode("ascii")
    elif isinstance(src, str):
        text = src
    else:
        text = src.read()

    rows = []
    meta = {}
    for line in text.splitlines():
        if line.startswith("Frag,"):
            parts = line.split(",")
            rows.append(parts[1:])
        elif " : " in line:
            key, _, val = line.partition(" : ")
            meta[key.strip()] = val.strip()

    n = len(rows)
    out = {
        "xStart": np.zeros(n, np.int32), "yStart": np.zeros(n, np.int32),
        "xEnd": np.zeros(n, np.int32), "yEnd": np.zeros(n, np.int32),
        "strand": np.zeros(n, np.int32), "length": np.zeros(n, np.int32),
        "score": np.zeros(n, np.int32), "idents": np.zeros(n, np.int32),
        "group": np.zeros(n, np.int32),
    }

    def _rec_offsets(axis: str):
        # "Records X : name:offset:length ..." -> offset per record id
        line = meta.get("Records " + axis)
        if not line:
            return None
        return np.array([int(p.rsplit(":", 2)[1]) for p in line.split()],
                        dtype=np.int64)

    record_mode = meta.get("Coords") == "record"
    offs_x = _rec_offsets("X") if record_mode else None
    offs_y = _rec_offsets("Y") if record_mode else None
    if record_mode and offs_y is None:
        offs_y = offs_x                  # self-comparison: one Records map
    for i, r in enumerate(rows):
        ox = oy = 0
        # A record id beyond the Records map means that side was single-
        # record, where the writer uses a fixed convention id (seqY=1 for
        # cross comparisons) and never shifts coordinates — offset 0.
        if record_mode:
            if offs_x is not None and len(r) > 11:
                rid = int(r[11])
                ox = int(offs_x[rid]) if rid < len(offs_x) else 0
            if offs_y is not None and len(r) > 12:
                rid = int(r[12])
                oy = int(offs_y[rid]) if rid < len(offs_y) else 0
        out["xStart"][i] = int(r[0]) - 1 + ox
        out["yStart"][i] = int(r[1]) - 1 + oy
        out["xEnd"][i] = int(r[2]) - 1 + ox
        out["yEnd"][i] = int(r[3]) - 1 + oy
        out["strand"][i] = 0 if r[4] == "f" else 1
        out["group"][i] = int(r[5])
        out["length"][i] = int(r[6])
        out["score"][i] = int(r[7])
        out["idents"][i] = int(r[8])
    out["_meta"] = meta  # type: ignore[assignment]
    return out
