"""ctypes bindings of the native host I/O library (csrc/repkiller_io.cpp,
the port's copy of the reference's native/repkiller_io.cpp): the FASTA
parser, 2-bit packing, reverse complement and the fragment CSV writer,
each giving the same bytes as its numpy or Python counterpart.

The library is built with ``g++`` at first use into ``_build/`` beside the
package (listed in .gitignore), named by a hash of the source's text, and
written under a temporary name then renamed, so processes that build at
once race safely. Without ``g++`` on PATH (and no build present),
``available()`` is false and the callers keep their numpy and Python
paths. With ``g++`` present, a failed build or load raises with the
compiler's or the loader's message.

Public surface:
  available() -> bool
  parse_fasta(data: bytes, spacer) -> (codes, offsets, lengths)   # no names
  pack_2bit(codes) -> (packed, nmask, length)
  revcomp(codes) -> codes
  write_frags_csv(dst, header, frag, self_cmp, rec_x, rec_y) -> threads
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, TextIO, Tuple, Union

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "repkiller_io.cpp"
BUILD_DIR = _PKG / "_build"

_i64 = ctypes.c_int64
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_SINK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, _i64)
_CSV_FIELDS = ("xStart", "yStart", "xEnd", "yEnd", "strand", "group",
               "length", "score", "idents")


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(source: Path) -> Optional[Path]:
    """The library of ``source``, compiled unless its build exists; None
    when it is not built and no ``g++`` is on PATH."""
    so = library_path(source)
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [gxx, "-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-o",
           str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib(source: Path) -> Optional[ctypes.CDLL]:
    so = build(source)
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.rk_fasta_sizes.restype = _i64
    lib.rk_fasta_sizes.argtypes = [ctypes.c_char_p, _i64, _i64,
                                   ctypes.POINTER(_i64)]
    lib.rk_fasta_parse.restype = _i64
    lib.rk_fasta_parse.argtypes = [ctypes.c_char_p, _i64, _i64, _p_u8,
                                   _p_i64, _p_i64]
    lib.rk_pack_2bit.restype = None
    lib.rk_pack_2bit.argtypes = [_p_u8, _i64, _p_u32, _p_u32, ctypes.c_int32]
    lib.rk_revcomp.restype = None
    lib.rk_revcomp.argtypes = [_p_u8, _i64, _p_u8]
    lib.rk_write_frags_csv.restype = _i64
    lib.rk_write_frags_csv.argtypes = (
        [ctypes.c_char_p, _SINK, ctypes.c_char_p, _i64] + [_p_i32] * 9
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)])
    return lib


def available() -> bool:
    return _lib(SOURCE) is not None


def _load() -> ctypes.CDLL:
    lib = _lib(SOURCE)
    if lib is None:
        raise RuntimeError("native I/O library unavailable: no g++ on PATH")
    return lib


def parse_fasta(data: bytes, spacer: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FASTA bytes -> (codes uint8 with ``spacer`` N codes between records,
    offsets int64, lengths int64), equal to io/fasta.parse_numpy's (the
    names are scanned apart)."""
    lib = _load()
    data = bytes(data)
    nrec = _i64(0)
    total = lib.rk_fasta_sizes(data, len(data), spacer, ctypes.byref(nrec))
    nrec = nrec.value
    codes = np.empty(total, np.uint8)
    offsets = np.empty(max(nrec, 1), np.int64)
    lengths = np.empty(max(nrec, 1), np.int64)
    got = lib.rk_fasta_parse(data, len(data), spacer, codes, offsets, lengths)
    if got != nrec:
        raise RuntimeError(f"native FASTA parse wrote {got} records of {nrec}")
    return codes, offsets[:nrec], lengths[:nrec]


def pack_2bit(codes: np.ndarray, n_threads: int = 0):
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    n = codes.shape[0]
    packed = np.empty((n + 15) // 16, np.uint32)
    nmask = np.empty((n + 31) // 32, np.uint32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.rk_pack_2bit(codes, n, packed, nmask, n_threads)
    return packed, nmask, n


def revcomp(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty_like(codes)
    lib.rk_revcomp(codes, codes.shape[0], out)
    return out


def write_frags_csv(dst: Union[str, TextIO], header: str,
                    frag: Dict[str, np.ndarray], self_cmp: bool,
                    rec_x: Optional[np.ndarray] = None,
                    rec_y: Optional[np.ndarray] = None) -> int:
    """``header`` then one ``Frag,...`` row per fragment, to the file at
    the path ``dst`` or to the text stream ``dst``: the same bytes as
    report/csv_writer's Python rows, with ``rec_x``/``rec_y`` (or the
    constants 0 and ``0 if self_cmp else 1``) in the seqX/seqY columns.
    Rows are formatted on up to min(8, cpu_count) threads, one for each
    block of rows begun -> the threads that formatted rows."""
    lib = _load()
    n = int(frag["xStart"].shape[0])
    cols = {f: np.ascontiguousarray(frag[f], np.int32)
            for f in _CSV_FIELDS if f != "group"}
    cols["group"] = np.ascontiguousarray(
        frag.get("group", np.zeros(n, np.int32)), np.int32)
    recs = {k: np.ascontiguousarray(v, np.int32)
            for k, v in (("rec_x", rec_x), ("rec_y", rec_y)) if v is not None}
    bad = [f for f, v in {**cols, **recs}.items() if v.shape != (n,)]
    if bad:
        raise ValueError(f"fragment columns {bad} do not hold {n} rows")
    pieces = []
    sink = _SINK(lambda data, size: pieces.append(ctypes.string_at(data, size)))
    path = dst.encode() if isinstance(dst, str) else None
    threads = ctypes.c_int32(0)
    got = lib.rk_write_frags_csv(
        path, sink, header.encode(), n, *(cols[f] for f in _CSV_FIELDS),
        *(recs[k].ctypes.data if k in recs else None
          for k in ("rec_x", "rec_y")),
        1 if self_cmp else 0, min(8, os.cpu_count() or 1),
        ctypes.byref(threads))
    if got < 0 or (path is None and sum(map(len, pieces)) != got):
        raise IOError(f"native CSV writer failed for {dst!r}")
    for piece in pieces:
        dst.write(piece.decode())
    return threads.value
