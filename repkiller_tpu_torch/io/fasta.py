"""FASTA ingestion (SURVEY.md §1 L0, §2.2 "FASTA ingestion"); the port's copy
of repkiller_tpu/io/fasta.py. ``read_fasta`` parses with the native C++
parser (io/native.py) when its library is available, else with
``parse_numpy``; both give the same codes.

Host-side reader: (multi-)FASTA -> ``SeqSet`` with concatenated uint8
codes, per-record names/offsets/lengths. Records are concatenated with a
single N spacer so k-mers never span record boundaries (any window
containing the spacer is invalid in the codec's N-mask).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import List, Union

import numpy as np

from ..utils import trace
from . import codec, native


@dataclass
class SeqSet:
    """A set of sequences packed into one concatenated code array."""

    codes: np.ndarray                 # uint8 concatenated codes (with N spacers)
    names: List[str] = field(default_factory=list)
    offsets: np.ndarray = None        # int64[nrec] start of each record in `codes`
    lengths: np.ndarray = None        # int64[nrec]
    path: str = ""

    @property
    def total_length(self) -> int:
        return int(self.codes.shape[0])

    def record(self, i: int) -> np.ndarray:
        o, l = int(self.offsets[i]), int(self.lengths[i])
        return self.codes[o : o + l]

    def locate(self, pos) -> tuple:
        """Global position(s) -> (record index, record-local position)."""
        pos = np.asarray(pos)
        ri = np.searchsorted(self.offsets, pos, side="right") - 1
        return ri, pos - self.offsets[ri]


@trace.traced("io.scan_names")
def _scan_names(data: bytes) -> List[str]:
    """Record names in parse_numpy's order and semantics (headers only; an
    implicit 'seq0' when sequence precedes the first header)."""
    names: List[str] = []
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            names.append(line[1:].split()[0].decode("ascii")
                         if len(line) > 1 else f"seq{len(names)}")
        elif not names:
            names.append("seq0")
    return names


DEFAULT_SPACER = 32   # N codes between records: long enough that x-drop
                      # kills any extension trying to bridge two records
                      # (default scoring: crossing costs >= min(32*|mismatch|,
                      # gap_open + 32*gap_extend) >> x_drop)


@trace.traced("io.read_fasta")
def read_fasta(src: Union[str, bytes, io.IOBase],
               spacer: int = DEFAULT_SPACER) -> SeqSet:
    """Parse FASTA from a path, bytes, or file object into a SeqSet.

    Records are concatenated with `spacer` N codes between them so k-mers
    and extensions never bridge records. Each call is an "io.read_fasta"
    trace span that counts the ``bytes`` read and the ``records``."""
    if isinstance(src, str) and (os.path.exists(src) or os.path.sep in src):
        with open(src, "rb") as f:
            data = f.read()
        path = src
    elif isinstance(src, str):
        data = src.encode("ascii")
        path = ""
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
        path = ""
    else:
        data = src.read()
        if isinstance(data, str):
            data = data.encode("ascii")
        path = getattr(src, "name", "")
    trace.count("bytes", len(data))

    # fast path: the native C++ parser (the same codes, offsets, lengths)
    if native.available():
        codes, offsets, lengths = native.parse_fasta(data, spacer)
        seqs = SeqSet(codes=codes, names=_scan_names(data),
                      offsets=offsets, lengths=lengths, path=path)
    else:
        seqs = parse_numpy(data, spacer, path)
    trace.count("records", len(seqs.names))
    return seqs


def parse_numpy(data: bytes, spacer: int = DEFAULT_SPACER,
                path: str = "") -> SeqSet:
    """read_fasta's numpy parse of FASTA bytes (no native library)."""
    names: List[str] = []
    chunks: List[np.ndarray] = []
    offsets: List[int] = []
    lengths: List[int] = []
    pos = 0
    spacer_arr = np.full(spacer, codec.NCODE, dtype=np.uint8)

    cur: List[bytes] = []

    def flush():
        nonlocal pos
        if not names:
            return
        seq = b"".join(cur)
        cod = codec.encode(seq)
        if chunks:
            chunks.append(spacer_arr)
            pos += spacer
        offsets.append(pos)
        lengths.append(len(cod))
        chunks.append(cod)
        pos += len(cod)
        cur.clear()

    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            flush()
            names.append(line[1:].split()[0].decode("ascii") if len(line) > 1 else f"seq{len(names)}")
        else:
            if not names:
                names.append("seq0")
            cur.append(line)
    flush()

    codes = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    return SeqSet(
        codes=codes,
        names=names,
        offsets=np.asarray(offsets, dtype=np.int64),
        lengths=np.asarray(lengths, dtype=np.int64),
        path=path,
    )


def from_codes(codes: np.ndarray, name: str = "seq0") -> SeqSet:
    codes = np.asarray(codes, dtype=np.uint8)
    return SeqSet(
        codes=codes,
        names=[name],
        offsets=np.zeros(1, dtype=np.int64),
        lengths=np.asarray([codes.shape[0]], dtype=np.int64),
    )
