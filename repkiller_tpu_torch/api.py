"""Public Python API of the port (counterpart of repkiller_tpu/api.py).

- :func:`compare` — full pipeline, FASTA/codes in, fragment table +
  repeat families out (the torch pipeline by default, the numpy oracle
  optional).
- :func:`group_fragments` — cluster an existing fragments CSV into
  families.
- :class:`Result` — fragment table + helpers for every output: annotated
  CSV, repeat intervals, family summary, masked sequence. The same class
  as the reference's, over the port's own writers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np

from . import device as _device
from .config import Config, DEFAULT
from .families import cluster_families
from .io import fasta
from .oracle import pipeline as orc
from .report import csv_writer, intervals as report_iv
from .table import canonical_sort, repeat_intervals
from .utils import trace

SeqLike = Union[str, bytes, np.ndarray, fasta.SeqSet]


def _as_seqset(x: SeqLike) -> fasta.SeqSet:
    if isinstance(x, fasta.SeqSet):
        return x
    if isinstance(x, np.ndarray):
        return fasta.from_codes(x)
    return fasta.read_fasta(x)


_LINE = 70
# code -> letter; any other code -> a byte that is not ASCII, so the text
# fails to decode
_LETTERS = b"ACGTN".ljust(256, b"\xff")


def _fasta_lines(codes: np.ndarray) -> str:
    """uint8 codes as FASTA text: lines of 70 letters, each ending in a
    newline, the last one shorter; a lone newline for no codes."""
    n = codes.shape[0]
    full, rest = divmod(n, _LINE)
    letters = np.frombuffer(codes.tobytes().translate(_LETTERS), np.uint8)
    lines = np.empty((full + (rest > 0), _LINE + 1), np.uint8)
    lines[:full, :_LINE] = letters[: full * _LINE].reshape(full, _LINE)
    lines[full:, :rest] = letters[full * _LINE :]
    lines[:, _LINE] = ord("\n")
    if rest:
        lines[full, rest] = ord("\n")
    size = n + lines.shape[0]
    return str(memoryview(lines.reshape(-1)[:size]), "ascii") or "\n"


@dataclass
class Result:
    """Comparison result: canonical fragment dict + provenance."""

    frag: Dict[str, np.ndarray]
    cfg: Config
    x: fasta.SeqSet
    y: Optional[fasta.SeqSet] = None

    @property
    def self_cmp(self) -> bool:
        return self.y is None

    @property
    def n_fragments(self) -> int:
        return int(self.frag["xStart"].shape[0])

    @property
    def n_families(self) -> int:
        return int(np.unique(self.frag["group"]).shape[0]) if self.n_fragments else 0

    def write_csv(self, dst, coords: str = "concat") -> None:
        """coords="record" writes record-local coordinates for
        multi-record inputs (csv_writer.write_frags_csv docstring)."""
        ys = self.x if self.self_cmp else self.y
        csv_writer.write_frags_csv(
            self.frag, dst,
            x_name=self.x.names[0] if self.x.names else "seqX",
            y_name=None if self.self_cmp else (ys.names[0] if ys.names else "seqY"),
            x_len=self.x.total_length, y_len=ys.total_length,
            x_seqs=self.x, y_seqs=None if self.self_cmp else ys,
            coords=coords,
        )

    def repeat_intervals(self) -> Dict[int, np.ndarray]:
        return repeat_intervals(self.frag, self.frag["group"], self.cfg,
                                self.self_cmp)

    def write_intervals(self, dst) -> Dict[int, np.ndarray]:
        ys = self.x if self.self_cmp else self.y
        return report_iv.write_intervals_bed(
            self.frag, self.cfg, dst, self.self_cmp,
            x_name=self.x.names[0] if self.x.names else "seqX",
            y_name=ys.names[0] if ys.names else "seqY",
            x_seqs=self.x, y_seqs=ys,
        )

    def write_family_summary(self, dst) -> Dict[str, np.ndarray]:
        return report_iv.write_family_summary(self.frag, dst)

    def masked_codes(self, space: int = 0) -> np.ndarray:
        iv = self.repeat_intervals().get(space)
        trace.count("intervals", 0 if iv is None else len(iv))
        src = self.x.codes if space == 0 else (self.y or self.x).codes
        return report_iv.mask_codes(src, iv)

    @trace.traced("report.masked_fasta")
    def masked_fasta(self, space: int = 0) -> str:
        """Hard-masked FASTA — one record per input record (multi-record
        SeqSets round-trip; inter-record N spacers are not emitted). Each
        call is a "report.masked_fasta" trace span that counts the
        ``intervals`` masked and the ``bytes`` of the text."""
        seqs = self.x if space == 0 else (self.y or self.x)
        masked = self.masked_codes(space)
        out = []
        n_rec = len(seqs.names) if seqs.names else 1
        for r in range(n_rec):
            o = int(seqs.offsets[r]) if seqs.offsets is not None else 0
            ln = int(seqs.lengths[r]) if seqs.lengths is not None \
                else masked.shape[0]
            name = seqs.names[r] if seqs.names else "seq0"
            out.append(">%s masked\n" % name)
            out.append(_fasta_lines(masked[o : o + ln]))
        text = "".join(out)
        trace.count("bytes", len(text))
        return text


def compare(x: SeqLike, y: Optional[SeqLike] = None, cfg: Config = DEFAULT,
            backend: str = "device", keep_intermediates: Optional[str] = None,
            *, device="cuda", mesh=None) -> Result:
    """Compare sequence X against Y (or itself when y is None) and detect
    repeat fragments and families.

    backend "device" runs the torch pipeline on ``device`` (default
    "cuda": without a GPU this raises, it never drops to the CPU; pass
    ``device="cpu"`` to run there). backend "sharded" runs
    dist.sharded.compare_sharded over ``mesh`` (default
    ``make_mesh(device=device)``: the ranks of an active process group,
    else every visible device of that type). backend "oracle" runs the
    numpy reference. All three give the same output. keep_intermediates
    (a directory; device backend only) runs the pipeline stage by stage,
    dumps each stage's arrays there, and lets a rerun with identical
    inputs resume from the last completed stage."""
    xs = _as_seqset(x)
    ys = _as_seqset(y) if y is not None else None
    if keep_intermediates and backend != "device":
        raise ValueError("--keep-intermediates requires the device backend "
                         "(streamed runs checkpoint per window instead)")
    codes_y = None if ys is None else ys.codes
    if backend == "device":
        frag = _device.compare(xs.codes, codes_y, cfg, device,
                               keep_intermediates=keep_intermediates)
    elif backend == "sharded":
        from .dist.sharded import compare_sharded
        frag = compare_sharded(xs.codes, codes_y, cfg, mesh, device=device)
    elif backend == "oracle":
        frag = orc.compare(xs.codes, codes_y, cfg)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return Result(frag=frag, cfg=cfg, x=xs, y=ys)


def group_fragments(frags_csv, cfg: Config = DEFAULT, self_cmp: bool = True,
                    *, device="cuda") -> Dict[str, np.ndarray]:
    """Read a fragments CSV, cluster it into repeat families and return the
    canonical-sorted fragment dict with a fresh "group" column. The
    clustering runs on ``device`` when it is a CUDA device with a GPU and
    the table is large enough (families/cluster.py), else on the host."""
    frag = csv_writer.read_frags_csv(frags_csv)
    frag.pop("_meta", None)
    frag = canonical_sort(frag)
    frag["group"] = cluster_families(frag, cfg, self_cmp, device=device)
    return frag
