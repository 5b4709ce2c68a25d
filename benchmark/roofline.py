"""Least device times of the port's counting kernels, from their shapes.

A kernel's bound is the larger of the bytes it must move over the memory
rate and the integer operations it must issue over the integer rate.
Bytes count each input read once and each output written once, whatever
the kernel reads again.  The peaks are NVIDIA's published ones for the
H100 SXM (80 GB HBM3) at its full 700 W power limit: 3.35 TB/s of HBM
bandwidth and 67 T 32-bit operations a second outside the tensor cores.
A card set below 700 W reaches less; the harness reports its power limit
beside every share.

K1 (`csrc/kmerize.cu`) writes W + 1 int32 planes (W canonical words and
the context) for every window of every read, and reads the packed rows
(ceil(L / 16) u32 words a read) and the usable lengths (one int32 a read).
K2 (`csrc/collapse.cu`) reads the sorted stream, W + 1 int32 planes, and
writes a row for every input row (kept rows, then fill), plus one int32
count a 4,096-row tile.  Both are bound by their bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
K2_TILE = 4096


def nwords(k: int) -> int:
    """u32 words of a k-mer."""
    return (k + 15) // 16


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """Least seconds for the work: bytes over the memory rate or
    operations over the integer rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S)


def k1_bytes(n_reads: int, read_len: int, k: int) -> int:
    """Bytes K1 moves over n_reads reads of read_len bases."""
    windows = n_reads * max(0, read_len - k + 1)
    return 4 * (nwords(k) + 1) * windows + 4 * n_reads * ((read_len + 15) // 16) + 4 * n_reads


def k2_bytes(rows: int, k: int) -> int:
    """Bytes K2 moves over a sorted stream of `rows` rows."""
    return 2 * 4 * (nwords(k) + 1) * rows + 4 * (-(-rows // K2_TILE))


def k1_bound_s(n_reads: int, read_len: int, k: int) -> float:
    return bound_s(k1_bytes(n_reads, read_len, k))


def k2_bound_s(rows: int, k: int) -> float:
    return bound_s(k2_bytes(rows, k))
