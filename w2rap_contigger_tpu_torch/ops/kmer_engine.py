"""Device-resident kmer counting: K1 kmerize -> torch sort -> K2 collapse.

Counterpart of w2rap_contigger_tpu/ops/kmer_engine.py:996-1207 (the
on-device counting path) and of its step entry count_kmers_batched
(:1433).  The chain, per the reference's createDictOMPRecursive
(src/paths/long/BuildReadQGraph.cc:1015-1110):

  reads --host pack (C++)--> packed rows + usable lengths, per chunk
        --K1 kmerize--> canonical word planes + context plane
        --pack into int64 keys, ctx riding in the last word's pad bits
          when >= 8 are free (kmer_engine.py:970-986)-->
        --two stable torch.sort passes, least significant key first-->
        --K2 collapse--> per-tile compacted (kmer, ctx, cnt) rows
        --global compaction (torch gather, _compact_planes_dev :1293)-->
        sorted dictionary + 101-bin histogram (low bins from K2, :1399)

The sort is lax.sort in the JAX package, outside any Pallas kernel, so
here it is a library sort.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device, timed
from . import bitkmer as bk
from .collapse import TILE, collapse
from .kmerize import kmerize, pack_and_glen_host


class KmerDict:
    """Sorted canonical kmer dictionary resident on one device.

    words (m, W) int64 u32 values sorted lexicographically; ctx and cnt
    (m,) int64.  After graph.build.build_unitigs the KDef planes
    (ReadPather.h:104) are set: edge_id / edge_offset / edge_rc as host
    numpy arrays and `kdef` as their device copies.  Host mirrors of the
    table materialize lazily (kmer_engine.py:275-330).
    """

    def __init__(self, words: torch.Tensor, cnt: torch.Tensor,
                 ctx: torch.Tensor, k: int):
        self.words = words
        self.cnt = cnt
        self._ctx = ctx
        self.k = k
        self.edge_id = None
        self.edge_offset = None
        self.edge_rc = None
        self.kdef = None
        self._host: dict[str, np.ndarray] = {}
        self._table_t = None

    @property
    def ctx(self) -> torch.Tensor:
        return self._ctx

    @ctx.setter
    def ctx(self, v: torch.Tensor) -> None:
        self._ctx = v
        self._host.pop("ctx", None)

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def size(self) -> int:
        return self.words.shape[0]

    def table_t(self) -> torch.Tensor:
        """(W, m) transposed table for the batched binary search."""
        if self._table_t is None:
            self._table_t = self.words.T.contiguous()
        return self._table_t

    def host(self, name: str) -> np.ndarray:
        """Host mirror: "words" (m, W) u32, "ctx" (m,) u32, "counts" (m,) i32."""
        if name not in self._host:
            src = {"words": self.words, "ctx": self.ctx, "counts": self.cnt}[name]
            dt = np.int32 if name == "counts" else np.uint32
            self._host[name] = src.cpu().numpy().astype(dt)
        return self._host[name]


def empty_dict(k: int, device) -> KmerDict:
    dev = torch.device(device)
    z = torch.zeros(0, dtype=torch.int64, device=dev)
    return KmerDict(z.reshape(0, bk.nwords(k)), z, z.clone(), k)


def _sort_keys(W: int) -> list[tuple[int, ...]]:
    """Word indices of each int64 sort key, most significant first."""
    keys = [(j, j + 1) for j in range(0, W - 1, 2)]
    if W % 2:
        keys.append((W - 1,))
    return keys


def sort_stream(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation that sorts rows by (keys[0], keys[1], ...): stable
    passes from the least significant key to the most significant."""
    perm = None
    for key in reversed(keys):
        kk = key if perm is None else key[perm]
        _, idx = torch.sort(kk, stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


def count_kmers_device(bases, lengths, quals, k: int, min_qual: int = 7,
                       min_freq: int = 4, chunk_reads: int = 65536,
                       device="cuda"):
    """Count canonical kmers on `device`; returns (KmerDict, hist).

    hist is the small_K.freqs histogram: hist[c] = distinct kmers with
    saturated count c, binned at min(100, count); the dictionary keeps
    count >= min_freq (BuildReadQGraph.cc:1095-1115).
    """
    dev = resolve_device(device)
    n, L = bases.shape
    W = bk.nwords(k)
    if L < k or n == 0:
        return empty_dict(k, dev), np.zeros(101, dtype=np.int64)
    P = L - k + 1
    n_rows = n * P
    pad_bits = 2 * (16 * W - k)
    ctx_in_pad = pad_bits >= 8
    key_words = _sort_keys(W)
    keys = [torch.empty(n_rows, dtype=torch.int64, device=dev) for _ in key_words]
    payload = None if ctx_in_pad else torch.empty(n_rows, dtype=torch.int64, device=dev)

    def host_chunk(start):
        stop = min(start + chunk_reads, n)
        pr, glen = pack_and_glen_host(
            bases[start:stop], quals[start:stop], lengths[start:stop], k, min_qual
        )
        return (
            torch.from_numpy(pr.view(np.int32)).to(dev),
            torch.from_numpy(glen).to(dev),
        )

    starts = list(range(0, n, chunk_reads))
    # double buffer: chunk i+1's host pack + upload runs on a worker
    # thread while chunk i's kernels run
    with timed("step2.count.kmerize", dev), ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(host_chunk, starts[0])
        for ci, start in enumerate(starts):
            pr_d, glen_d = fut.result()
            if ci + 1 < len(starts):
                fut = pool.submit(host_chunk, starts[ci + 1])
            x = bk.from_raw32(kmerize(pr_d, glen_d, k, L))
            lo, hi = start * P, start * P + x.shape[1]
            ctx = x[W]
            if ctx_in_pad:
                x[W - 1] |= ctx
            else:
                valid = ~(x[:W] == bk.FULL).all(dim=0)
                payload[lo:hi] = torch.where(valid, (ctx << 8) | 1, 0)
            for key, idx in zip(keys, key_words):
                key[lo:hi] = bk.pair_key(x[idx[0]], x[idx[1]]) if len(idx) == 2 else x[idx[0]]
            del x

    with timed("step2.count.sort", dev):
        perm = sort_stream(keys)
        planes = torch.empty((W + 1, n_rows), dtype=torch.int32, device=dev)
        for key, idx in zip(keys, key_words):
            s = key[perm]
            if len(idx) == 2:
                planes[idx[0]] = bk.to_raw32(((s >> 32) & bk.FULL) ^ bk.SIGN)
                planes[idx[1]] = bk.to_raw32(s & bk.FULL)
            else:
                planes[idx[0]] = bk.to_raw32(s)
        del keys
        if ctx_in_pad:
            # strip ctx from the pad bits; sentinel rows were all-ones before
            last = bk.from_raw32(planes[W - 1])
            w_last = last & (bk.FULL ^ 0xFF)
            sent = w_last == (bk.FULL ^ 0xFF)
            for j in range(W - 1):
                sent &= planes[j] == -1
            planes[W] = bk.to_raw32(torch.where(sent, 0, ((last & 0xFF) << 8) | 1))
            planes[W - 1] = bk.to_raw32(torch.where(sent, bk.FULL, w_last))
        else:
            planes[W] = bk.to_raw32(payload[perm])
        del perm, payload
    with timed("step2.count.collapse", dev):
        return dict_from_collapsed(collapse(planes, min_count=min_freq), W, k, min_freq)


def compact_tiles(out: torch.Tensor, tile_counts: torch.Tensor, tile: int):
    """Gather each collapse tile's kept rows into one compact (W+1, m)
    table (the counterpart of _compact_planes_dev, kmer_engine.py:1293)."""
    counts = tile_counts.to(torch.int64)
    m = int(counts.sum())
    first = torch.cumsum(counts, 0) - counts
    base = torch.arange(counts.numel(), device=out.device) * tile - first
    src = torch.repeat_interleave(base, counts, output_size=m)
    src += torch.arange(m, device=out.device)
    return out[:, src]


def dict_from_collapsed(collapsed, W: int, k: int, min_freq: int):
    """(KmerDict, hist) from K2's outputs (kmer_engine.py:1376-1413)."""
    out, tile_counts, low_bins = collapsed
    table = bk.from_raw32(compact_tiles(out, tile_counts, TILE))
    words = table[:W].T.contiguous()
    pay = table[W]
    ctx = (pay >> 8) & 0xFF
    cnt = pay & 0xFF
    hist = torch.bincount(cnt.clamp(max=100), minlength=101).cpu().numpy().astype(np.int64)
    lb = low_bins.cpu().numpy()
    hi = min(min_freq, 101)
    hist[1:hi] = lb[1:hi]
    hist[0] = 0
    return KmerDict(words, cnt, ctx, k), hist


def count_kmers_batched(bases, lengths, quals, k: int, min_qual: int = 7,
                        min_freq: int = 4, chunk_reads: int = 65536,
                        disk_batches: int = 0, tmp_dir: str | None = None,
                        max_mem_gb: int = 10000, device="cuda"):
    """Step-2 counting entry (kmer_engine.py:1433).  Range or disk
    batching (-d > 1, or a working set above max_mem_gb) is not ported
    yet and raises."""
    W = bk.nwords(k)
    n_rows = int(bases.shape[0]) * max(0, int(bases.shape[1]) - k + 1)
    bytes_needed = n_rows * 4 * (W + 1) * 3
    budget = float(max_mem_gb) * (1 << 30)
    n_batches = max(1, int(disk_batches))
    while n_batches < 256 and bytes_needed / n_batches > budget:
        n_batches *= 2
    if n_batches > 1:
        raise NotImplementedError(
            f"range/disk-batched counting ({n_batches} batches from -d "
            f"{disk_batches} / -m {max_mem_gb}) is not ported yet; see "
            "ROADMAP.md"
        )
    return count_kmers_device(
        bases, lengths, quals, k, min_qual=min_qual, min_freq=min_freq,
        chunk_reads=chunk_reads, device=device,
    )
