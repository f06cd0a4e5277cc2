"""2-bit DNA codec (SURVEY.md §1 L0, §2.2 "2-bit codec"); the port's copy of
repkiller_tpu/io/codec.py.

Host-side (numpy) packing of DNA into HBM-friendly arrays:

- ``encode``: bytes/str -> uint8 codes, A=0 C=1 G=2 T=3, anything else
  (N, ambiguity codes, lowercase soft-mask is uppercased first) = 4.
- ``pack_2bit``: uint8 codes -> uint32 words, 16 bases per word,
  base ``i`` in bits ``2*(i % 16)`` (little-endian within the word, so
  ``(word >> 2*(i%16)) & 3`` recovers base ``i``). N positions pack as 0
  and are tracked in a separate validity bitmap (1 bit per base, uint32
  words, bit ``i%32`` of word ``i//32`` set iff base ``i`` is A/C/G/T).
- ``revcomp_codes``: reverse complement on code arrays (N stays N).

The device pipeline consumes ``(packed, nmask, length)``; the oracle
consumes the uint8 codes directly. Both derive from ``encode`` so they
agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

# uint8 code for "not ACGT"
NCODE = 4

_LUT = np.full(256, NCODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[ord(chr(_b).lower())] = _i


def encode(seq) -> np.ndarray:
    """str/bytes/uint8-array of IUPAC letters -> uint8 codes (A0 C1 G2 T3, else 4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    buf = np.frombuffer(bytes(seq), dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return _LUT[buf]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> string (N for code 4)."""
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 code array; involution; N -> N."""
    codes = np.asarray(codes, dtype=np.uint8)
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return comp[::-1].copy()


def pack_2bit(codes: np.ndarray):
    """uint8 codes -> (packed uint32[ceil(L/16)], nmask uint32[ceil(L/32)], L).

    N (code 4) packs as base 0 with its validity bit cleared.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = codes.shape[0]
    valid = codes < 4
    b2 = np.where(valid, codes, 0).astype(np.uint32)

    nwords = (L + 15) // 16
    padded = np.zeros(nwords * 16, dtype=np.uint32)
    padded[:L] = b2
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    packed = (padded.reshape(nwords, 16) << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)

    mwords = (L + 31) // 32
    vpad = np.zeros(mwords * 32, dtype=np.uint32)
    vpad[:L] = valid.astype(np.uint32)
    bshifts = np.arange(32, dtype=np.uint32)
    nmask = (vpad.reshape(mwords, 32) << bshifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    return packed, nmask, L


def unpack_2bit(packed: np.ndarray, nmask: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_2bit -> uint8 codes (N restored from the validity bitmap)."""
    packed = np.asarray(packed, dtype=np.uint32)
    idx = np.arange(length)
    base = (packed[idx // 16] >> ((idx % 16).astype(np.uint32) * 2)) & 3
    valid = (np.asarray(nmask, dtype=np.uint32)[idx // 32] >> (idx % 32).astype(np.uint32)) & 1
    return np.where(valid == 1, base, NCODE).astype(np.uint8)
