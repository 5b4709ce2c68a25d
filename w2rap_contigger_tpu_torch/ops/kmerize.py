"""K1: kmerize + canonicalize 2-bit packed reads.

`kmerize` is the wrapper of the CUDA kernel csrc/kmerize.cu, which
replaces the TPU kernel w2rap_contigger_tpu/ops/pallas_kmer.py:
_kmerize_kernel (:64).  `kmerize_plain` is the same function in plain
PyTorch; the wrapper takes it only for tensors on the CPU.

Both return (W+1, N*P) int32 planes of raw u32 bits, row r*P + p for
read r and window p (P = L-k+1): W canonical word planes (all-ones
sentinels where the window is invalid) and the KMerContext plane (0
where invalid).  The row order is the port's own; the JAX kernel emits
another permutation, so the two are compared as multisets.

The host-side packing (`pack_rows_host`, `good_lengths_host`,
`pack_and_glen_host`) is copied from pallas_kmer.py:151-216 and uses
the shared g++ loader for native/pack_kernel.cc.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as tdev
from ..shared import native
from . import _build
from . import bitkmer as bk
from . import context as kctx


def pack_rows_host(bases):
    """(N, L) u8 codes -> (N, ceil(L/16)) u32 big-endian 2-bit rows."""
    bases = np.asarray(bases, dtype=np.uint32)
    n, L = bases.shape
    Wr = (L + 15) // 16
    padded = np.zeros((n, Wr * 16), dtype=np.uint32)
    padded[:, :L] = bases
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    return np.bitwise_or.reduce(
        padded.reshape(n, Wr, 16) << shifts[None, None, :], axis=-1
    ).astype(np.uint32)


def good_lengths_host(quals, lengths, k: int, min_qual: int):
    """Per-read usable prefix length (count_good_lengths,
    BuildReadQGraph.cc:962-987)."""
    quals = np.asarray(quals)
    n, L = quals.shape
    pos = np.arange(L, dtype=np.int32)[None, :]
    good = (quals >= np.uint8(min_qual)) & (pos < np.asarray(lengths)[:, None])
    badpos = np.where(good, np.int32(L), pos)
    next_bad = np.minimum.accumulate(badpos[:, ::-1], axis=1)[:, ::-1]
    run = next_bad - pos
    i_max = np.max(np.where(run >= k, pos, -1), axis=1)
    return np.where(i_max >= 0, i_max + k, 0).astype(np.int32)


def pack_and_glen_host(bases, quals, lengths, k: int, min_qual: int):
    """2-bit packing + usable-prefix lengths in one C++ pass
    (native/pack_kernel.cc), or the numpy mirrors without a toolchain."""
    import ctypes

    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, L = bases.shape
    Wr = (L + 15) // 16
    lib = native.load("w2rappack", ["pack_kernel.cc"])
    if lib is None:
        return (
            pack_rows_host(bases),
            good_lengths_host(quals, lengths, k, min_qual),
        )
    packed = np.empty((n, Wr), dtype=np.uint32)
    glen = np.empty(n, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.w2rap_pack_glen(
        bases.ctypes.data_as(u8p),
        quals.ctypes.data_as(u8p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n),
        ctypes.c_int64(L),
        ctypes.c_int64(Wr),
        ctypes.c_int32(k),
        ctypes.c_int32(min_qual),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        glen.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return packed, glen


def _check(packed: torch.Tensor, glen: torch.Tensor, k: int, L: int) -> int:
    if packed.dtype != torch.int32 or glen.dtype != torch.int32:
        raise TypeError("kmerize takes int32 packed rows and int32 glen")
    if packed.dim() != 2 or glen.shape != (packed.shape[0],):
        raise ValueError(f"bad shapes packed {tuple(packed.shape)} glen {tuple(glen.shape)}")
    if packed.device != glen.device:
        raise ValueError("packed and glen on different devices")
    if packed.shape[1] != (L + 15) // 16:
        raise ValueError(f"packed rows hold {packed.shape[1]} words, L={L} needs {(L + 15) // 16}")
    if not 1 <= bk.nwords(k) <= 17:
        raise ValueError(f"k={k}: the kmerize kernel takes W=1..17 words")
    if L < k:
        raise ValueError(f"L={L} < k={k}: no windows")
    return L - k + 1


def kmerize_plain(packed: torch.Tensor, glen: torch.Tensor, k: int, L: int):
    """Plain PyTorch K1 on any device (the CPU tests' path)."""
    P = _check(packed, glen, k, L)
    n = packed.shape[0]
    W = bk.nwords(k)
    pk = bk.from_raw32(packed)
    g = glen.to(torch.int64)[:, None]
    fw = bk.kmer_windows(pk, k, P)  # (n, P, W)
    pos = torch.arange(P, device=packed.device)[None, :]
    n_kmers = torch.where(g > k, g - k + 1, 0)
    valid = pos < n_kmers
    has_pred = valid & (pos > 0)
    has_succ = valid & (pos + k < g)

    def base_at(i):
        i = i.clamp(0, 16 * pk.shape[1] - 1)
        return (pk[:, i >> 4] >> (30 - 2 * (i & 15))) & 3

    ctx = kctx.make_context(
        base_at(pos[0] - 1), base_at(pos[0] + k),
        has_pred.to(torch.int64), has_succ.to(torch.int64),
    )
    canon, is_rev = bk.canonicalize(fw, k)
    ctx = torch.where(is_rev, kctx.rc_context(ctx), ctx)
    canon = torch.where(valid[..., None], canon, bk.FULL)
    ctx = torch.where(valid, ctx, 0)
    planes = torch.cat([canon.reshape(n * P, W).T, ctx.reshape(1, n * P)])
    return bk.to_raw32(planes).contiguous()


def kmerize(packed: torch.Tensor, glen: torch.Tensor, k: int, L: int):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (W+1, N*P) int32 planes."""
    if packed.device.type == "cpu":
        return kmerize_plain(packed, glen, k, L)
    P = _check(packed, glen, k, L)
    if packed.device.type != "cuda":
        raise ValueError(f"kmerize: unsupported device {packed.device}")
    if not (packed.is_contiguous() and glen.is_contiguous()):
        raise ValueError("kmerize takes contiguous tensors")
    n = packed.shape[0]
    W = bk.nwords(k)
    out = torch.empty((W + 1, n * P), dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    err = _build.library().w2rap_kmerize(
        packed.data_ptr(), n, packed.shape[1], glen.data_ptr(), k, P,
        out.data_ptr(), n * P,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _build.check(err, "w2rap_kmerize")
    tdev.count_launch("kmerize")
    return out
