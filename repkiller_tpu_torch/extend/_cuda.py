"""Build and ctypes bindings of the hand-written CUDA kernels: K1
(csrc/banded_gotoh.cu) and K2 (csrc/ungapped_xdrop.cu).

``build`` compiles any ``csrc/*.cu`` with ``nvcc`` into a plain shared
library of its own (``_build/`` beside the package, listed in .gitignore),
named by the source's stem and a hash of its text, and loads it with
ctypes: each C interface takes device pointers and a ``cudaStream_t``, so
no torch headers are compiled. Several sources build at once, one nvcc
process each. A failed compile or launch raises with the compiler's or
the runtime's message. Each launch counts in the trace (utils/trace.py):
K1's as ``k1_launches``, K2's as ``k2_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import trace
from .ungapped import check_max_extend

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
BANDED_SOURCE = CSRC / "banded_gotoh.cu"
UNGAPPED_SOURCE = CSRC / "ungapped_xdrop.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(*sources: Path) -> list:
    """Compile each source's library unless its build exists, all nvcc
    processes running together -> the libraries' paths. The compiler's
    report (``-Xptxas -v``: registers, spills) is kept beside each as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        so = library_path(src)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), "-O3", "-arch=sm_90a", "-std=c++17", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((so, tmp, cmd, proc))
    failed = []
    for so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}: "
                          f"{' '.join(cmd)}\n{out}")
            continue
        Path(f"{so}.log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(src) for src in sources]


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "rk_banded_gotoh": [_P, _P, _P, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "rk_ungapped_xdrop": [_P, _P, _P, _P, _LL, _P, _LL, _P, _I, _I, _I, _I,
                          _I, _I, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _lib(source: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, argtypes in _ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    if hasattr(lib, "rk_banded_needs_scratch"):
        lib.rk_banded_needs_scratch.argtypes = [_I] * 6
        lib.rk_banded_needs_scratch.restype = ctypes.c_int
    lib.rk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-D {dtype} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_seeds(kernel: str, px, py, valid, cx, cy):
    """Device, dtype and shape checks shared by both kernels -> device."""
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {dev}")
    for t, name, dt in ((px, "px", torch.int32), (py, "py", torch.int32),
                        (valid, "valid", torch.bool), (cx, "cx", torch.uint8),
                        (cy, "cy", torch.uint8)):
        _check(t, name, dt, dev)
    if py.shape[0] != px.shape[0] or valid.shape[0] != px.shape[0]:
        raise ValueError("px, py and valid differ in length")
    return dev


def _launch(source: Path, fn: str, dev, *args) -> None:
    lib = _lib(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.rk_cuda_error_string(err).decode())


def banded_gotoh(px, py, valid, cx, cy, base_off: int, step: int,
                 match: int, mismatch: int, x_drop: int, E: int, band: int,
                 gap_open: int, gap_extend: int, jcap: int, n_live):
    """Launch K1 on CUDA tensors -> (ei, ej, gain, idents, alive) int32[n];
    the same contract as extend.banded.direction_plain. ``n_live`` may be
    an int or a 0-d tensor; a tensor stays on the device (no host sync).
    Any scores and x_drop are taken. ``rk_banded_needs_scratch`` of the C
    source picks the kernel from the arguments (csrc/banded_gotoh.cu says
    why); the wide kernel runs in a (4, 2 * band + 1, n) int32 scratch
    buffer allocated here. A band below 0 raises ValueError."""
    dev = _check_seeds("banded_gotoh", px, py, valid, cx, cy)
    wide = _lib(BANDED_SOURCE).rk_banded_needs_scratch(
        band, match, mismatch, E, gap_open, gap_extend)
    if wide < 0:
        raise ValueError(f"banded_gotoh needs band >= 0, got {band}")
    n = px.shape[0]
    nl = torch.as_tensor(n_live, dtype=torch.int32, device=dev).reshape(())
    out = torch.empty((5, n), dtype=torch.int32, device=dev)
    scratch = (torch.empty((4, 2 * band + 1, n), dtype=torch.int32,
                           device=dev) if n and wide else None)
    if n:
        _launch(BANDED_SOURCE, "rk_banded_gotoh", dev,
                px.data_ptr(), py.data_ptr(), valid.data_ptr(),
                cx.data_ptr(), cx.shape[0], cy.data_ptr(), cy.shape[0],
                nl.data_ptr(), n, base_off, step, match, mismatch, x_drop,
                E, band, gap_open, gap_extend, jcap, out.data_ptr(),
                None if scratch is None else scratch.data_ptr())
        trace.count("k1_launches")
    return tuple(out.unbind(0))


def ungapped_xdrop(px, py, valid, cx, cy, base_off: int, step: int,
                   match: int, mismatch: int, x_drop: int, E: int, n_live):
    """Launch K2 on CUDA tensors -> (ext, gain, idents) int32[n]; the same
    contract as extend.ungapped.direction_plain. ``n_live`` may be an int
    or a 0-d tensor; a tensor stays on the device (no host sync)."""
    check_max_extend(E)
    dev = _check_seeds("ungapped_xdrop", px, py, valid, cx, cy)
    n = px.shape[0]
    nl = torch.as_tensor(n_live, dtype=torch.int32, device=dev).reshape(())
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    if n:
        _launch(UNGAPPED_SOURCE, "rk_ungapped_xdrop", dev,
                px.data_ptr(), py.data_ptr(), valid.data_ptr(),
                cx.data_ptr(), cx.shape[0], cy.data_ptr(), cy.shape[0],
                nl.data_ptr(), n, base_off, step, match, mismatch, x_drop, E,
                out.data_ptr())
        trace.count("k2_launches")
    return tuple(out.unbind(0))
