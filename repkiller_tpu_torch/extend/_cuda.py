"""Build and ctypes binding of the hand-written CUDA kernel K1
(csrc/banded_gotoh.cu).

The source is compiled at first use with ``nvcc`` into a plain shared
library (``_build/`` beside the package, listed in .gitignore), named by a
hash of the source, and loaded with ctypes: the C interface takes device
pointers and a ``cudaStream_t``, so no torch headers are compiled. A failed
compile or launch raises with the compiler's or the runtime's message.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "banded_gotoh.cu"
BUILD_DIR = _PKG / "_build"
MAX_BAND = 32                    # the kernel's largest register row: W <= 65


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> Path:
    """Compile the kernel library unless this source's build exists; the
    compiler's report (``-Xptxas -v``: registers, spills) is kept beside
    it as ``<library>.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libbanded_gotoh-{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), "-O3", "-arch=sm_90a", "-std=c++17", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    Path(f"{so}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rk_banded_gotoh.argtypes = [p, p, p, p, ll, p, ll, p, i, i, i, i, i, i,
                                    i, i, i, i, i, p, p]
    lib.rk_banded_gotoh.restype = ctypes.c_int
    lib.rk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-D {dtype} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def banded_gotoh(px, py, valid, cx, cy, base_off: int, step: int,
                 match: int, mismatch: int, x_drop: int, E: int, band: int,
                 gap_open: int, gap_extend: int, jcap: int, n_live):
    """Launch K1 on CUDA tensors -> (ei, ej, gain, idents, alive) int32[n];
    the same contract as extend.banded.direction_plain. ``n_live`` may be
    an int or a 0-d tensor; a tensor stays on the device (no host sync)."""
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"band {band} outside the kernel's 0..{MAX_BAND}")
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"banded_gotoh needs CUDA tensors, got {dev}")
    for t, name, dt in ((px, "px", torch.int32), (py, "py", torch.int32),
                        (valid, "valid", torch.bool), (cx, "cx", torch.uint8),
                        (cy, "cy", torch.uint8)):
        _check(t, name, dt, dev)
    n = px.shape[0]
    if py.shape[0] != n or valid.shape[0] != n:
        raise ValueError("px, py and valid differ in length")
    nl = torch.as_tensor(n_live, dtype=torch.int32, device=dev).reshape(())
    out = torch.empty((5, n), dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.rk_banded_gotoh(
                px.data_ptr(), py.data_ptr(), valid.data_ptr(),
                cx.data_ptr(), cx.shape[0], cy.data_ptr(), cy.shape[0],
                nl.data_ptr(), n, base_off, step, match, mismatch, x_drop,
                E, band, gap_open, gap_extend, jcap, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("banded_gotoh launch failed: "
                               + lib.rk_cuda_error_string(err).decode())
        banded_gotoh.launches += 1
    return tuple(out.unbind(0))


banded_gotoh.launches = 0
