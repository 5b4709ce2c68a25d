"""ctypes bindings for the native fastq loader (native/fastq_loader.cc).

`load_fastq_readset(path)` parses a fastq or fastq.gz file straight into
the dense (N, Lmax) tensors of :class:`~w2rap_contigger_tpu_torch.core.reads.
ReadSet` without Python-object intermediates — the native equivalent of
the reference's streaming read extraction (ExtractReads.cc:45-688).
Returns None when the native library is unavailable (callers fall back
to the numpy parser in io_fastq)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .reads import ReadSet
from .. import native

_SIG_DONE = False


def _lib():
    global _SIG_DONE
    lib = native.load("w2rapio", ["fastq_loader.cc"], libs=["z"])
    if lib is not None and not _SIG_DONE:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.w2rap_gunzip.argtypes = [u8p, ctypes.c_uint64, u8p, u64p]
        lib.w2rap_gunzip.restype = ctypes.c_int
        lib.w2rap_fastq_scan.argtypes = [u8p, ctypes.c_uint64, u64p, u64p]
        lib.w2rap_fastq_scan.restype = ctypes.c_int
        lib.w2rap_fastq_fill.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, u8p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.w2rap_fastq_fill.restype = ctypes.c_int64
        _SIG_DONE = True
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def available() -> bool:
    return _lib() is not None


def gunzip(data: bytes) -> bytes:
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    n = ctypes.c_uint64(0)
    rc = lib.w2rap_gunzip(_u8ptr(buf), len(data), None, ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"gunzip size pass failed ({rc})")
    out = np.empty(n.value, dtype=np.uint8)
    rc = lib.w2rap_gunzip(_u8ptr(buf), len(data), _u8ptr(out),
                          ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"gunzip failed ({rc})")
    return out[:n.value].tobytes()


def load_fastq_readset(path: str) -> ReadSet | None:
    lib = _lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".gz"):
        raw = gunzip(raw)
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = ctypes.c_uint64(0)
    lmax = ctypes.c_uint64(0)
    rc = lib.w2rap_fastq_scan(_u8ptr(buf), len(buf), ctypes.byref(n),
                              ctypes.byref(lmax))
    if rc != 0:
        raise ValueError(f"{path}: malformed fastq (scan rc={rc})")
    bases = np.zeros((n.value, lmax.value), dtype=np.uint8)
    quals = np.zeros((n.value, lmax.value), dtype=np.uint8)
    lengths = np.zeros(n.value, dtype=np.int32)
    filled = lib.w2rap_fastq_fill(
        _u8ptr(buf), len(buf), lmax.value, _u8ptr(bases), _u8ptr(quals),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if filled != n.value:
        raise ValueError(f"{path}: malformed fastq (fill rc={filled})")
    return ReadSet(bases, lengths, quals)
