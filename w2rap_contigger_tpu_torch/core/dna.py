"""Host-side DNA utilities: ASCII <-> 2-bit codes, reverse complement, N50.

Base codes A=0 C=1 G=2 T=3 (reference: src/dna/Bases.h).  Ns are mapped to
A at load time, matching the reference's ExtractReads behavior
(src/paths/long/large/ExtractReads.cc — 'treating N as A').
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# ASCII -> code lookup; everything unknown (incl. N) maps to A=0.
ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ASCII_TO_CODE[_b] = _i
    ASCII_TO_CODE[ord(chr(_b).lower())] = _i

CODE_TO_ASCII = np.zeros(256, dtype=np.uint8)
CODE_TO_ASCII[:4] = BASES


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    return CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a base-code array (complement = 3 - code)."""
    return (3 - np.asarray(codes))[::-1].astype(np.uint8)


def canonical_codes(codes: np.ndarray) -> tuple[np.ndarray, bool]:
    """Canonical form of a code sequence; returns (canon, was_rc).

    REV iff rc < fwd lexicographically (reference BaseVec.h:325-333).
    """
    rc = revcomp_codes(codes)
    a, b = codes.tobytes(), rc.tobytes()
    if b < a:
        return rc, True
    return np.asarray(codes, dtype=np.uint8), False


def n50(lengths, min_len: int = 0) -> int:
    """N50 of a set of lengths, considering only lengths >= min_len.

    Matches math/Functions.h N50 semantics: the length L such that half the
    total is in pieces >= L.
    """
    ls = np.sort(np.asarray([l for l in lengths if l >= min_len]))[::-1]
    if ls.size == 0:
        return 0
    total = int(ls.sum())
    csum = np.cumsum(ls)
    idx = int(np.searchsorted(csum, (total + 1) // 2))
    return int(ls[min(idx, ls.size - 1)])
