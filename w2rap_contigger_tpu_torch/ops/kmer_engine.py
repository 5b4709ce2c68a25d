"""Device-resident kmer counting: kmerize -> sort -> K2 collapse.

Counterpart of w2rap_contigger_tpu/ops/kmer_engine.py:635-833 (flat
counting, step 3) and :996-1287 (the on-device counting path shared by
steps 2 and 3), and of the step-2 entry count_kmers_batched (:1433).
The chain, per the reference's createDictOMPRecursive
(src/paths/long/BuildReadQGraph.cc:1015-1110):

  reads --host pack (C++)--> packed rows + usable lengths, per chunk
        --K1 kmerize--> canonical word planes + context plane
  (step 3: place sequences --torch kmerize_flat--> the same planes)
        --the stream: W word planes, ctx riding in the last word's pad
          bits when >= 8 are free (kmer_engine.py:970-986), else a
          payload plane (ctx << 8) | 1-->
        --sort, W2RAP_SORT=lax (default): stable torch.sort passes over
          int64 keys, least significant first (lax.sort in JAX);
          W2RAP_SORT=radix: the partition sort K4a-d, with an exact lax
          recount on slot overflow or comparator collision;
          W2RAP_SORT=pallas: the bitonic network K3a/b on W word planes
          + the payload plane, padded with sentinels to a power of two
          (:1139-1141, :1174-1181), exact on all W words-->
        --K2 collapse--> per-tile compacted (kmer, ctx, cnt) rows
        --global compaction (torch gather, _compact_planes_dev :1293)-->
        sorted dictionary + 101-bin histogram (low bins from K2, :1399)

Range batching (`count_kmers_batched`, -d / -m): the reads are packed
and uploaded once, one K1 pass counts the rows of each hash range (the
top bits of word 0), and each range is a pass of its own: K1 again, a
stream of only that range's rows, the sort and K2, each on the device.
The ranges' dictionaries, spilled to --tmp_dir or kept, concatenate in
range order into the unbatched dictionary.

Sharded counting (`count_kmers_sharded`, `count_kmers_flat(mesh=)`,
--shard): each shard of a parallel.mesh.Mesh kmerizes its reads or
position chunks, every valid row is copied to the stream of the shard
that owns its hash (parallel.mesh.bucket_of), each owner sorts and
collapses its rows on its device, and one multiword sort orders the
owners' disjoint dictionaries on the first shard's device.

Step 5's blob-local graphs count on the host instead (`count_kmers_flat
(..., host=True)`, :663-713 and :836-885): the C++ leaf
`native/count_kernel.cc` kmerizes, sorts and collapses segment batches,
and `host_merge_sorted` merges the sorted runs into a `HostKmerDict` of
numpy arrays.  JAX's fallback there is its device pipeline; the port has
none on the host, so a leaf that cannot build raises.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import note, resolve_device, timed, to_host, wait_host
from ..parallel.mesh import bucket_of, on, shard_chunk
from . import bitkmer as bk
from . import bitonic
from . import context as kctx
from . import radix
from .collapse import LOW_BINS, TILE, collapse
from .kmerize import kmerize, pack_and_glen_host, pack_rows_host


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


class HostKmerDict:
    """Sorted canonical kmer dictionary in host numpy arrays (the JAX
    package's KmerDict with dev None, kmer_engine.py:275-357): words (m, W)
    uint32, counts (m,) int32, ctx (m,) uint32, and the KDef planes
    edge_id / edge_offset / edge_rc once graph.build.build_unitigs ran.
    The graph and pathing functions take their host routes for it."""

    def __init__(self, words, counts, ctx, k: int):
        self.words = words
        self.counts = counts
        self.ctx = ctx
        self.k = k
        self.edge_id = None
        self.edge_offset = None
        self.edge_rc = None

    @property
    def size(self) -> int:
        return self.words.shape[0]


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


# ---------------------------------------------------------------------------
# the counting stream and its sort back ends (kmer_engine.py:1119-1287)
# ---------------------------------------------------------------------------

RADIX_RECOUNTS = 0  # radix sorts that fell back to the exact lax recount


def sort_backend() -> str:
    """W2RAP_SORT: "lax" (default; the library sort, lax.sort in JAX),
    "radix" (the partition sort, K4a-d) or "pallas" (the bitonic sort,
    K3a/b)."""
    backend = os.environ.get("W2RAP_SORT", "lax")
    if backend not in ("lax", "radix", "pallas"):
        raise ValueError(f"W2RAP_SORT={backend!r}: lax, radix or pallas")
    return backend


def _sort_kind(backend: str, n_rows: int) -> str:
    """The sort a stream of n_rows takes: radix falls back to lax on tiny
    inputs, where the partition setup is not worth it (:1136-1137)."""
    if backend == "radix" and n_rows < 4 * radix.DEFAULT_TILE_ROWS * radix.LANES:
        return "lax"
    return backend


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class Stream:
    """The counting stream: the valid kmers of up to `capacity` windows
    as W word planes of raw u32 bits, with ctx in the last word's pad
    bits when >= 8 are free (kmer_engine.py:970-986), else W words + a
    payload plane (ctx << 8) | 1.

    Invalid windows (all-ones words) are dropped as they arrive: they
    never reach the dictionary, and the sort has fewer rows to move.  The
    JAX package keeps them as sentinel rows; the rows the sort sees are
    the port's own (its row order already differs).

    The pallas back end needs a power of two of rows: the stream is
    padded with sentinels (all-ones words, payload 0) to max(next_pow2(n
    + 1), 128) rows (:1139-1141), and ctx never rides in the pad bits: the
    W words are the sort's keys, the payload plane rides along
    (:1174-1176).

    The radix back end needs whole tiles.  Its padding rows (sentinels:
    all-ones words, payload 0) are spread over the tiles, a few at the
    end of each: JAX's splitters take the samples of rank b * n_tiles - 1,
    so tiles whose samples sit apart (one tile mostly of padding, or tiles
    with more invalid windows than others) push the splitters into the
    next sample group and nearly double some bins' loads against the
    slot's overflow threshold.

    Under radix, ctx also never rides in a comparator word (W <= 4):
    there the splitters would see the context bits, and a splitter
    falling between two contexts of one kmer would cut the kmer across
    two bins (two dictionary rows).  JAX's radix branch does ride it
    there (:1253-1262, comparator words at W <= 2).
    """

    def __init__(self, capacity: int, W: int, k: int, backend: str, dev,
                 range_bits: int = 0, range_index: int = 0):
        self.W = W
        self.backend = backend
        self.ctx_in_pad = 2 * (16 * W - k) >= 8 and backend != "pallas" and not (
            backend == "radix" and W <= radix.MAX_CMP_KEYS)
        self.buf = torch.empty((W if self.ctx_in_pad else W + 1, capacity),
                               dtype=torch.int32, device=dev)
        self.n = 0
        self.range_bits = range_bits
        self.range_index = range_index

    def layout(self, words: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """The stream's rows of a chunk's windows: words (W, m) and ctx
        (m,) as raw int32 bits -> (planes, m)."""
        W = self.W
        if self.ctx_in_pad:
            return torch.cat([words[: W - 1], (words[W - 1] | ctx)[None]])
        return torch.cat([words, ((ctx << 8) | 1)[None]])

    def put(self, words: torch.Tensor, ctx: torch.Tensor) -> None:
        """Append the valid kmers of a chunk: words (W, m) and ctx (m,) as
        raw int32 bits, all-ones words where the window is invalid.  With
        range_bits, only the kmers of range range_index stay."""
        valid = valid_windows(words)
        if self.range_bits:
            valid &= range_of(words[0], self.range_bits) == self.range_index
        self.append(self.layout(words, ctx)[:, valid])

    def append(self, rows: torch.Tensor) -> None:
        """Append laid-out rows (`layout`), copied from any device on the
        source's current stream, a plane at a time: each copy is
        contiguous, so one from another card needs no staging buffer on
        this card's current stream."""
        m = rows.shape[1]
        if self.n + m > self.buf.shape[1]:
            raise RuntimeError(f"stream of {self.buf.shape[1]} rows: {self.n} + {m} do not fit")
        for j in range(rows.shape[0]):
            self.buf[j, self.n : self.n + m].copy_(rows[j], non_blocking=True)
        self.n += m

    def planes(self) -> tuple[torch.Tensor, str]:
        """(planes, kind): the contiguous stream for the sort, and the sort
        that takes it (lax, radix: whole tiles, padding spread; or pallas:
        a power of two of rows, padding at the end)."""
        buf, n = self.buf, self.n
        self.buf = None
        kind = _sort_kind(self.backend, n)
        if kind == "lax":
            return buf[:, :n], kind
        if kind == "pallas":
            n_pad = max(_next_pow2(n + 1), bitonic.LANES)
            planes = torch.empty((buf.shape[0], n_pad), dtype=torch.int32, device=buf.device)
            planes[:, :n] = buf[:, :n]
            planes[: self.W, n:] = -1
            planes[self.W :, n:] = 0
            return planes, kind
        return spread_padding(buf[:, :n], self.W, radix.DEFAULT_TILE_ROWS * radix.LANES), kind


def valid_windows(words: torch.Tensor) -> torch.Tensor:
    """(m,) mask of the windows that hold a kmer: words (W, m) are all
    ones where a window is invalid."""
    return ~(words == -1).all(dim=0)


def spread_padding(rows: torch.Tensor, W: int, T: int) -> torch.Tensor:
    """(num_ops, n) rows -> whole T-row tiles, the padding rows (all ones
    in the W key planes, 0 in the others) spread a few at the end of each
    tile: the radix stream's layout (Stream)."""
    n = rows.shape[1]
    n_pad = -(-n // T) * T
    planes = torch.empty((rows.shape[0], n_pad), dtype=torch.int32, device=rows.device)
    if n_pad == n:
        planes.copy_(rows)
        return planes
    planes[:W] = -1
    planes[W:] = 0
    n_tiles = n_pad // T
    q, rem = divmod(n_pad - n, n_tiles)
    # tiles < rem keep T-q-1 real rows at their front, the others T-q
    b0 = rem * (T - q - 1)
    i = torch.arange(n, device=rows.device)
    t = torch.where(i < b0, i // (T - q - 1), rem + (i - b0) // (T - q))
    planes[:, i + t * q + torch.clamp(t, max=rem)] = rows
    return planes


def _strip_ctx(sp: torch.Tensor) -> torch.Tensor:
    """(W, n) sorted planes with ctx in the pad bits -> (W+1, n) planes
    with the payload plane; sentinel rows were all-ones before."""
    W, n = sp.shape
    out = torch.empty((W + 1, n), dtype=torch.int32, device=sp.device)
    out[: W - 1] = sp[: W - 1]
    last = bk.from_raw32(sp[W - 1])
    w_last = last & (bk.FULL ^ 0xFF)
    sent = (w_last == (bk.FULL ^ 0xFF)) & (sp[: W - 1] == -1).all(dim=0)
    out[W - 1] = bk.to_raw32(torch.where(sent, bk.FULL, w_last))
    out[W] = bk.to_raw32(torch.where(sent, 0, ((last & 0xFF) << 8) | 1))
    return out


def _lax_sorted(planes: torch.Tensor, W: int, ctx_in_pad: bool) -> torch.Tensor:
    """Exact sort on every word: stable torch.sort passes over int64 keys
    of two words each, least significant first."""
    words = [bk.from_raw32(planes[j]) for j in range(W)]
    keys = [bk.pair_key(words[i[0]], words[i[1]]) if len(i) == 2 else words[i[0]]
            for i in _sort_keys(W)]
    del words
    perm = sort_stream(keys)
    del keys
    sp = planes[:, perm]
    return _strip_ctx(sp) if ctx_in_pad else sp


def _radix_sorted(planes: torch.Tensor, W: int, ctx_in_pad: bool):
    """Partition sort (K4a-d) on the first min(W, 4) words: (sorted
    planes, flags), flags (2,) int64 on the device: non-zero when a slot
    overflowed or two distinct kmers tie on those words, and the caller
    must recount exactly (kmer_engine.py:1161-1172, :1244-1287).

    JAX compares 2 words; the port compares 4 (128 bits), which covers
    every kmer up to k=64: at k=60 on reads with errors, distinct kmers
    sharing their first 32 bases are common, so a 2-word comparator
    would raise the collision flag on nearly every data set."""
    cmp_keys = min(W, radix.MAX_CMP_KEYS)
    sp, overflow = radix.partition_sort(planes, num_keys=W, cmp_keys=cmp_keys)
    if ctx_in_pad:
        sp = _strip_ctx(sp)
    # on ctx-stripped words: equal kmers with other contexts do not collide
    bad = radix.collision_flag(sp, num_keys=W, cmp_keys=cmp_keys)
    return sp, torch.stack([overflow[0].to(torch.int64), bad])


def _sorted_stream(stream: Stream):
    """The sort of a filled stream: (sorted planes, the planes kept for an
    exact recount or None, flags (2,) int64 or None; _radix_sorted)."""
    W, ctx_in_pad = stream.W, stream.ctx_in_pad
    planes, kind = stream.planes()
    if kind == "pallas":  # the stream's own copy: sorted in place
        return bitonic.bitonic_sort(planes, num_keys=W), None, None
    if kind == "radix":
        sp, flags = _radix_sorted(planes, W, ctx_in_pad)
        return sp, planes, flags
    return _lax_sorted(planes, W, ctx_in_pad), None, None


def _collapse_enqueued(sp: torch.Tensor, min_freq: int):
    """K2 on sorted planes, and the start of the copy to the host of what
    the compaction needs: [kept rows, K2's low bins].
    Returns ((out, tile_counts, low_bins), to_host copy)."""
    collapsed = collapse(sp, min_count=min_freq)
    _, tile_counts, low_bins = collapsed
    vals = torch.cat([tile_counts.to(torch.int64).sum()[None], low_bins.to(torch.int64)])
    return collapsed, to_host(vals)


BIN_LANES = 256  # copies of a histogram that _bincount's atomic adds spread over


def _bincount(x: torch.Tensor, bins: int) -> torch.Tensor:
    """torch.bincount(x, minlength=bins) of x in [0, bins) as int64, on
    the device with no host wait (torch.bincount reads x's maximum back):
    element i adds into copy i mod BIN_LANES, so the adds of a warp never
    meet on one address (into a single copy, they serialise)."""
    idx = torch.arange(x.numel(), dtype=torch.int32, device=x.device) % BIN_LANES * bins
    idx += x.to(torch.int32)
    counts = torch.zeros(BIN_LANES * bins, dtype=torch.int32, device=x.device)
    return counts.index_add_(0, idx, torch.ones_like(idx)).view(BIN_LANES, bins).sum(dim=0)


def count_epilogues(streams: list, k: int, min_freq: int, span: str, mesh=None,
                    marks: list | None = None):
    """Sort + K2 collapse + compaction of filled streams, one an owner:
    [(KmerDict, hist)] (kmer_engine.py:1119-1207).  Shared by steps 2 and
    3; the one-device counts pass one stream and no mesh.

    Every owner's sort (the `.sort` span) and K2 are enqueued, each on
    its shard's stream (mesh.on), before one host wait reads back every
    owner's kept rows and low bins; then every owner's compaction and
    histogram are enqueued before a second wait reads the histograms.
    Under radix, one wait more, once every owner's sort is enqueued, reads
    their flags before K2: the unsorted planes are freed before K2 (as a
    one-device sort frees them), and the owners whose flags are set are
    sorted again exactly (a lax sort) before their K2; the dictionary is
    the same.  marks, when given, receives each owner's four timing
    events on a card (before and after its sort, before and after its K2
    and read back; None on the CPU or for an empty owner)."""
    global RADIX_RECOUNTS
    W, ctx_in_pad = streams[0].W, streams[0].ctx_in_pad
    devices = [st.buf.device for st in streams]
    span_devices = mesh.devices if mesh is not None else devices[0]
    hist0 = np.zeros(101, dtype=np.int64)
    parts = [(empty_dict(k, dev), hist0.copy()) for dev in devices]
    live = [o for o, st in enumerate(streams) if st.n]
    ev = {o: [] for o in live}
    sort = {}
    with timed(f"{span}.sort", span_devices):
        for o in live:
            with on(mesh, o):
                note("sort", o)
                ev[o].append(_mark(devices[o]))
                sort[o] = _sorted_stream(streams[o])
                ev[o].append(_mark(devices[o]))
        radix, pending = [o for o in live if sort[o][2] is not None], []
        for o in radix:
            with on(mesh, o):
                pending.append(to_host(sort[o][2]))
        flags = dict(zip(radix, wait_host(pending, "radix flags"))) if radix else {}
        for o in live:
            sp, planes, _ = sort[o]
            if o in flags and flags[o].any():
                RADIX_RECOUNTS += 1
                with on(mesh, o):
                    note("recount", o)
                    sp = _lax_sorted(planes, W, ctx_in_pad)
            sort[o] = sp
            del sp, planes
    with timed(f"{span}.collapse", span_devices):
        coll, pending = {}, []
        for o in live:
            with on(mesh, o):
                note("collapse", o)
                ev[o].append(_mark(devices[o]))
                coll[o], copy = _collapse_enqueued(sort.pop(o), min_freq)
                ev[o].append(_mark(devices[o]))
            pending.append(copy)
        vals = dict(zip(live, wait_host(pending, "epilogue")))
        pending = []
        for o in live:
            with on(mesh, o):
                note("compact", o)
                parts[o] = _dict_of(coll.pop(o), int(vals[o][0]), W, k)
                pending.append(to_host(_bincount(parts[o].cnt.clamp(max=100), 101)))
        for o, hist in zip(live, wait_host(pending, "histogram")):
            parts[o] = (parts[o], _hist_of(hist, vals[o], min_freq))
    if marks is not None:
        marks[:] = [ev[o] if o in ev and ev[o][0] is not None else None
                    for o in range(len(streams))]
    return parts


def _mark(dev: torch.device):
    """A timing event on the current stream of a card; None on the CPU."""
    if dev.type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _dict_of(collapsed, m: int, W: int, k: int) -> KmerDict:
    """The KmerDict of K2's m kept rows (kmer_engine.py:1376-1398)."""
    out, tile_counts, _ = collapsed
    table = bk.from_raw32(compact_tiles(out, tile_counts, TILE, m))
    pay = table[W]
    return KmerDict(table[:W].T.contiguous(), pay & 0xFF, (pay >> 8) & 0xFF, k)


def _hist_of(hist: np.ndarray, vals: np.ndarray, min_freq: int) -> np.ndarray:
    """small_K.freqs's histogram: the kept rows' bins (_bincount), and
    below min_freq K2's low bins (vals, _collapse_enqueued's read back;
    :1399-1413)."""
    hist = hist.astype(np.int64)
    hi = min(min_freq, 101)
    hist[1:hi] = vals[1 : 1 + LOW_BINS][1:hi]
    hist[0] = 0
    return hist


def range_of(w0: torch.Tensor, range_bits: int) -> torch.Tensor:
    """Hash range of each kmer: the top range_bits bits of word 0 (raw
    int32 bits, taken as u32: >> on int32 would carry the sign), as
    _payload_mask_core does (kmer_engine.py:916-928).  Ranges ascend in
    the dictionary's order, so their dictionaries concatenate."""
    return (w0.to(torch.int64) & bk.FULL) >> (32 - range_bits)


def _prefetched(host_fn, items, dev, stream=None):
    """Yield host_fn(item)'s numpy arrays as tensors on `dev`, item by
    item: item i+1's host work and upload run on a worker thread while
    the caller's kernels run on item i.  On a card the worker copies from
    pageable memory on its own current stream and waits for its copy
    (pinning each array cost more than it saved on an H100 host: PERF.md
    §6); the caller's `stream` (default: its current stream) waits for
    the copy, and the tensors are marked as used there."""
    items = list(items)
    dev = torch.device(dev)
    if stream is None and dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)

    def work(item):
        arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host_fn(item))
        return arrays, (torch.cuda.current_stream(dev).record_event() if stream is not None
                        else None)

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(work, items[0]) if items else None
        for i in range(len(items)):
            arrays, copied = fut.result()
            if i + 1 < len(items):
                fut = pool.submit(work, items[i + 1])
            if copied is not None:
                stream.wait_event(copied)
                for t in arrays:
                    t.record_stream(stream)
            yield arrays


def _round_robin(gens):
    """(shard, item) from (shard, generator) pairs, one item of each in
    turn until all are drained: the shards' workers run at once."""
    for items in itertools.zip_longest(*(gen for _, gen in gens)):
        for (s, _), item in zip(gens, items):
            if item is not None:
                yield s, item


def _device_chunks(bases, lengths, quals, k: int, min_qual: int,
                   chunk_reads: int, dev, stream=None):
    """Yield (packed rows, usable lengths) of each chunk of reads on
    `dev`, packed and uploaded ahead on a worker thread (_prefetched)."""
    n = bases.shape[0]

    def host_chunk(start):
        stop = min(start + chunk_reads, n)
        pr, glen = pack_and_glen_host(
            bases[start:stop], quals[start:stop], lengths[start:stop], k, min_qual
        )
        return pr.view(np.int32), glen

    return _prefetched(host_chunk, range(0, n, chunk_reads), dev, stream)


def _count_chunks(chunks, capacity: int, k: int, L: int, min_freq: int, dev,
                  span: str, range_bits: int = 0, range_index: int = 0):
    """K1 over the packed chunks into a stream of `capacity` rows (the
    range's rows with range_bits), then the sort and K2: (KmerDict, hist)."""
    W = bk.nwords(k)
    stream = Stream(capacity, W, k, sort_backend(), dev, range_bits, range_index)
    with timed(f"{span}.kmerize", dev):
        for pr_d, glen_d in chunks:
            x = kmerize(pr_d, glen_d, k, L)
            stream.put(x[:W], x[W])
            del x
    return count_epilogues([stream], k, min_freq, span)[0]


def count_kmers_device(bases, lengths, quals, k: int, min_qual: int = 7,
                       min_freq: int = 4, chunk_reads: int = 65536,
                       device="cuda", span: str = "step2.count",
                       range_bits: int = 0, range_index: int = 0):
    """Count canonical kmers on `device`; returns (KmerDict, hist).

    hist is the small_K.freqs histogram: hist[c] = distinct kmers with
    saturated count c, binned at min(100, count); the dictionary keeps
    count >= min_freq (BuildReadQGraph.cc:1095-1115).  range_bits > 0
    counts only the kmers of hash range range_index (range_of).
    """
    dev = resolve_device(device)
    n, L = bases.shape
    if L < k or n == 0:
        return empty_dict(k, dev), np.zeros(101, dtype=np.int64)
    chunks = _device_chunks(bases, lengths, quals, k, min_qual, chunk_reads, dev)
    return _count_chunks(chunks, n * (L - k + 1), k, L, min_freq, dev, span,
                         range_bits, range_index)


def compact_tiles(out: torch.Tensor, tile_counts: torch.Tensor, tile: int, m: int):
    """Gather each collapse tile's kept rows into one compact (W+1, m)
    table (the counterpart of _compact_planes_dev, kmer_engine.py:1293);
    m is the kept rows, tile_counts' sum."""
    counts = tile_counts.to(torch.int64)
    first = torch.cumsum(counts, 0) - counts
    base = torch.arange(counts.numel(), device=out.device) * tile - first
    src = torch.repeat_interleave(base, counts, output_size=m)
    src += torch.arange(m, device=out.device)
    return out[:, src]


MAX_RANGE_BITS = 8  # at most 256 hash ranges, as the JAX package's rule


def count_row_bytes(W: int) -> int:
    """Device bytes a stream row costs step 2's count at its peak: the
    stream and about three copies of it (the sort's keys, its output, the
    gathered planes).  Measured: 77 B a window at W = 4, the unbatched
    count's peak over its windows at E. coli scale and 16 Mbp (NVIDIA H100
    80GB HBM3, lax sort; radix within 2%, pallas below)."""
    return 16 * (W + 1)


def range_sizes(chunks, k: int, L: int) -> list[int]:
    """Valid kmer rows of each of the 2^MAX_RANGE_BITS finest hash
    ranges: one K1 pass over the packed chunks."""
    W = bk.nwords(k)
    sizes = 0
    for pr_d, glen_d in chunks:
        x = kmerize(pr_d, glen_d, k, L)
        valid = valid_windows(x[:W])
        sizes = sizes + torch.bincount(range_of(x[0][valid], MAX_RANGE_BITS),
                                       minlength=1 << MAX_RANGE_BITS)
        del x
    return sizes.tolist()


def ranges_at(sizes: list[int], range_bits: int) -> list[int]:
    """Rows of each of the 2^range_bits ranges from the finest sizes."""
    step = len(sizes) >> range_bits
    return [sum(sizes[i : i + step]) for i in range(0, len(sizes), step)]


def ceiling_range_bits(sizes: list[int], range_bits: int, room: float,
                       row_bytes: int) -> int:
    """The fewest range bits, at least range_bits, whose largest range
    fits `room` device bytes at row_bytes a row; MAX_RANGE_BITS when none
    does.  Canonical kmers crowd the low ranges (about 7/16 of the rows in
    the first of 4), so equal shares of the working set do not bound it."""
    while (range_bits < MAX_RANGE_BITS
           and max(ranges_at(sizes, range_bits)) * row_bytes > room):
        range_bits += 1
    return range_bits


def count_kmers_batched(bases, lengths, quals, k: int, min_qual: int = 7,
                        min_freq: int = 4, chunk_reads: int = 65536,
                        disk_batches: int = 0, tmp_dir: str | None = None,
                        max_mem_gb: int = 10000, device="cuda"):
    """Step-2 counting entry (kmer_engine.py:1433-1533): disk_batches > 1,
    or a working set above max_mem_gb (the SetMaxMemory analogue,
    System.cc:1027), splits the canonical kmer space into 2^b hash ranges
    (range_of) counted in separate passes, each range optionally spilled
    to tmp_dir as npz; the ranges are disjoint and ascending, so the dict
    is their concatenation, bit for bit the unbatched one (the reference's
    createDictOMPDiskBased, BuildReadQGraph.cc:1120-1250).

    Every pass runs K1, the sort and K2 on `device`.  The reads are packed
    and uploaded once (a few bytes a base); one K1 pass counts each
    range's rows, and each range's stream holds only its rows, so the
    sort's footprint shrinks with the range.  (The JAX package cannot drop
    out-of-range rows before its device sort, kmer_engine.py:1489-1507,
    and takes its native host spill instead, :1471-1487.)

    The number of ranges starts from the JAX package's rule (equal shares
    of its working-set estimate), then doubles until the largest range,
    as the sizing pass counted it, fits max_mem_gb beside the packed
    reads (count_row_bytes), up to 256 ranges.  --tmp_dir bounds no
    device peak: the ranges' dictionaries are small next to a range's
    stream, and the reload puts them all back on the device."""
    W = bk.nwords(k)
    n_rows = int(bases.shape[0]) * max(0, int(bases.shape[1]) - k + 1)
    bytes_needed = n_rows * 4 * (W + 1) * 3  # stream + sort ping/pong
    budget = float(max_mem_gb) * (1 << 30)
    n_batches = max(1, int(disk_batches))
    while n_batches < 1 << MAX_RANGE_BITS and bytes_needed / n_batches > budget:
        n_batches *= 2
    range_bits = max(0, int(n_batches - 1).bit_length())
    row_bytes = count_row_bytes(W)
    dev = resolve_device(device)
    span = "step2.count"
    n, L = bases.shape
    if L < k or n == 0 or (range_bits == 0 and n_rows * row_bytes <= budget):
        return count_kmers_device(
            bases, lengths, quals, k, min_qual=min_qual, min_freq=min_freq,
            chunk_reads=chunk_reads, device=dev,
        )
    with timed(f"{span}.pack", dev):
        chunks = list(_device_chunks(bases, lengths, quals, k, min_qual,
                                     chunk_reads, dev))
    with timed(f"{span}.range_sizes", dev):
        fine = range_sizes(chunks, k, L)
    room = budget - sum(pr.nbytes + gl.nbytes for pr, gl in chunks)
    range_bits = ceiling_range_bits(fine, range_bits, room, row_bytes)
    sizes = ranges_at(fine, range_bits)
    hist = np.zeros(101, dtype=np.int64)
    parts = []
    for ri, size in enumerate(sizes):
        d, h = _count_chunks(chunks, size, k, L, min_freq, dev, span, range_bits, ri)
        hist += h
        if tmp_dir:
            os.makedirs(tmp_dir, exist_ok=True)
            path = os.path.join(tmp_dir, f"kmer_range_{ri:04d}.npz")
            np.savez(path, words=d.host("words"), counts=d.host("counts"),
                     ctx=d.host("ctx"))
            parts.append(path)
        else:
            parts.append((d.words, d.cnt, d.ctx))
        del d
    del chunks
    if tmp_dir:
        spilled, parts = parts, []
        for path in spilled:
            with np.load(path) as z:
                parts.append(tuple(torch.from_numpy(z[key].astype(np.int64)).to(dev)
                                   for key in ("words", "counts", "ctx")))
            os.remove(path)
    words, cnt, ctx = (torch.cat([p[i] for p in parts]) for i in range(3))
    return KmerDict(words, cnt, ctx, k), hist


# ---------------------------------------------------------------------------
# sharded counting (parallel/mesh.py count_kmers_sharded :76-219, and the
# flat fan-out kmer_engine.py:750-775)
# ---------------------------------------------------------------------------


def _owner_of(words: torch.Tensor, D: int) -> torch.Tensor:
    """The shard that owns each window's kmer (its `bucket_of` hash), D
    where the window is invalid."""
    return torch.where(valid_windows(words), bucket_of(words[0], D), D)


def _exchange(words: torch.Tensor, ctx: torch.Tensor, streams: list[Stream],
              counts: list[int]) -> None:
    """Send a chunk's valid rows to their owners' streams: a stable sort
    by owner (the invalid windows last), then one copy a non-empty owner
    of the counts[o] rows the sizing pass counted for it."""
    rows = streams[0].layout(words, ctx)
    order = torch.sort(_owner_of(words, len(streams)), stable=True)[1]
    rows = rows[:, order[: sum(counts)]]
    start = 0
    for st, m in zip(streams, counts):
        if m:
            st.append(rows[:, start : start + m])
        start += m


def _gather_dicts(parts, dev, k: int):
    """One dictionary on `dev` from the owners' (KmerDict, hist): the
    dictionaries hold disjoint kmers, so one multiword sort of their rows
    orders them; the histograms add up."""
    words, cnt, ctx = (torch.cat([getattr(d, a).to(dev) for d, _ in parts])
                       for a in ("words", "cnt", "ctx"))
    keys = [bk.pair_key(words[:, i[0]], words[:, i[1]]) if len(i) == 2 else words[:, i[0]]
            for i in _sort_keys(words.shape[1])]
    perm = sort_stream(keys)
    return KmerDict(words[perm], cnt[perm], ctx[perm], k), sum(h for _, h in parts)


def _count_exchanged(chunks, kmerize_of, mesh, W: int, k: int, min_freq: int,
                     span: str, stats: dict | None):
    """The sharded count of `chunks`, (shard, inputs) pairs iterated once
    (the iterator may pack and upload as it goes), where kmerize_of(inputs)
    gives the chunk's (words (W, m), ctx (m,)) raw int32 on the shard's
    device.  Each shard's work is enqueued on its stream (mesh.on), and
    the host waits do not grow with the chunks or the owners:

    * `.size`: each chunk is kmerized and its rows counted by owner on
      its device; one host wait reads those counts, which size every
      owner's stream exactly (never D full-size streams) and place each
      chunk's rows in it;
    * `.exchange`: each chunk is kmerized again and its rows are copied
      to their owners' streams;
    * `.sort`, `.collapse` (count_epilogues): each owner sorts and
      collapses its stream (sort back end + K2 at min_freq: a kmer lives
      in one stream, so filtering a stream at a time is filtering
      globally), two host waits reading every owner's sizes, then
      every owner's histogram (under radix a third, before K2, reads
      every owner's flags);
    * `.gather`: the dictionaries gather on mesh.devices[0].

    `stats`, when given, receives the rows each owner held, the rows and
    bytes that left their source shard, and each owner's device ms of its
    sort and of its K2 (`owner_ms`, None on the CPU or for an empty
    owner)."""
    D = mesh.size
    devs = mesh.devices
    kept, pending = [], []
    with timed(f"{span}.kmerize", devs):
        with timed(f"{span}.size", devs):
            for s, inputs in chunks:
                with mesh.on(s):
                    note("size", s)
                    pending.append(to_host(_bincount(_owner_of(kmerize_of(inputs)[0], D), D + 1)))
                kept.append((s, inputs))
            owned = np.stack(wait_host(pending, "sizes"))[:, :D]  # [chunk, owner]
        rows = owned.sum(axis=0).tolist()
        backend = sort_backend()
        streams = []
        for o in range(D):
            with mesh.on(o):
                streams.append(Stream(rows[o], W, k, backend, devs[o]))
        planes = streams[0].buf.shape[0]
        with timed(f"{span}.exchange", devs):
            mesh.barrier()  # the sources write into buffers the owners allocated
            for (s, inputs), counts in zip(kept, owned.tolist()):
                with mesh.on(s):
                    note("exchange", s)
                    _exchange(*kmerize_of(inputs), streams, counts)
            mesh.barrier()  # each owner sorts once every source's copies ended
    moved = int(owned.sum() - sum(owned[i, s] for i, (s, _) in enumerate(kept)))
    del kept
    marks = []
    parts = count_epilogues(streams, k, min_freq, span, mesh, marks)
    del streams
    with timed(f"{span}.gather", devs):
        mesh.join(*(t for d, _ in parts for t in (d.words, d.cnt, d.ctx)))
        out = _gather_dicts(parts, devs[0], k)
    if stats is not None:
        stats.update(rows=rows, exchanged_rows=moved, exchanged_bytes=moved * 4 * planes,
                     owner_ms=[None if ev is None else [ev[0].elapsed_time(ev[1]),
                                                        ev[2].elapsed_time(ev[3])]
                               for ev in marks])
    return out


def count_kmers_sharded(bases, lengths, quals, k: int, mesh, min_qual: int = 7,
                        min_freq: int = 4, chunk_reads: int = 65536,
                        stats: dict | None = None):
    """Step 2's count over a mesh (JAX mesh.count_kmers_sharded,
    mesh.py:76-167): (KmerDict on mesh.devices[0], hist), bit for bit
    count_kmers_device's.

    The reads split into mesh.size contiguous shards; each shard packs
    its reads on a worker thread of its own and uploads them once, while
    K1 runs on the chunks that came before (the chunks are taken from
    the shards in turn); every valid row goes to the stream of the shard
    that owns its `bucket_of` hash, and each owner runs the sort back end
    and K2 on what it owns.  K1 runs twice a chunk (the sizing pass, then
    the exchange); the packed chunks stay on their devices between the
    two.  `stats`: _count_exchanged's."""
    dev0 = mesh.devices[0]
    n, L = bases.shape
    if L < k or n == 0:
        return empty_dict(k, dev0), np.zeros(101, dtype=np.int64)
    W = bk.nwords(k)

    def k1(inputs):
        x = kmerize(*inputs, k, L)
        return x[:W], x[W]

    chunks = _round_robin([
        (s, _device_chunks(bases[lo:hi], lengths[lo:hi], quals[lo:hi], k, min_qual,
                           chunk_reads, mesh.devices[s], mesh.shard_streams[s]))
        for s, (lo, hi) in enumerate(mesh.slices(n)) if hi > lo])
    return _count_exchanged(chunks, k1, mesh, W, k, min_freq, "step2.count", stats)


# ---------------------------------------------------------------------------
# flat counting (step 3's place sequences, kmer_engine.py:635-833)
# ---------------------------------------------------------------------------


def kmerize_flat(packed, valid, has_pred, has_succ, pred_code, succ_code, k: int):
    """Canonical kmers of a flat chunk (_kmerize_flat_impl, :635-655;
    XLA there, so plain torch here on every device).

    packed (1, WR) int64 u32 rows of the chunk's bases plus a halo; the
    masks and context bases (C,) come from the host's segment bounds.
    Returns (words (W, C), ctx (C,)) as raw int32 bits, all-ones words
    and ctx 0 where invalid."""
    C = valid.shape[0]
    words = bk.kmer_windows(packed, k, C)[0]
    ctx = kctx.make_context(pred_code, succ_code, has_pred.to(torch.int64),
                            has_succ.to(torch.int64))
    canon, is_rev = bk.canonicalize(words, k)
    ctx = torch.where(is_rev, kctx.rc_context(ctx), ctx)
    canon = torch.where(valid[:, None], canon, bk.FULL)
    ctx = torch.where(valid, ctx, 0)
    return bk.to_raw32(canon.T), bk.to_raw32(ctx)


def _flat_chunk_host(flat_bases, seg_start, seg_end, st: int, C: int, k: int):
    """Host arrays of flat positions st..st+C (:718-745): the packed bases
    with a halo, (1, WR) raw int32, and (5, C) uint8 rows: valid,
    has_pred, has_succ, the predecessor base, the successor base."""
    T = len(flat_bases)
    halo = 16 * ((k + 15) // 16)
    cb = np.zeros(C + halo, dtype=np.uint8)
    avail = min(T - st, C + halo)
    cb[:avail] = flat_bases[st : st + avail]
    pos = np.arange(st, st + C)
    end = seg_end[st : st + C]
    valid = pos + k <= end
    hp = valid & (pos > seg_start[st : st + C])
    hs = valid & (pos + k < end)
    pc = flat_bases[np.maximum(pos - 1, 0)]
    sc = flat_bases[np.minimum(pos + k, T - 1)]
    return (pack_rows_host(cb[None]).view(np.int32),
            np.stack([valid, hp, hs, pc, sc]).astype(np.uint8))


def count_kmers_flat(flat_bases, seg_offsets, k: int, min_freq: int = 1,
                     chunk_pos: int | None = None, device="cuda",
                     span: str = "step3.count", host: bool = False, mesh=None,
                     stats: dict | None = None):
    """Count canonical kmers over concatenated sequences (:663-833, its
    device pipeline branch :783-824); returns the KmerDict.

    flat_bases (T,) uint8 codes of all sequences back to back;
    seg_offsets (S+1,) int64 bounds.  No kmer spans two sequences; a
    kmer's context bases stop at its sequence's ends.

    mesh deals the position chunks over its shards (chunk i on shard i
    mod D, the chunk clamped so that every shard gets one) and counts
    them as count_kmers_sharded does (JAX :750-775): each chunk's host
    arrays are made and uploaded once, on a worker thread of its shard,
    and stay on the shard's device for both passes; the dictionary lands
    on mesh.devices[0], `device` is not used, and `stats` receives
    _count_exchanged's.

    host=True counts with the native C++ leaf and returns a HostKmerDict
    (step 5's blob-local graphs; `device` is not used)."""
    W = bk.nwords(k)
    if host:
        if len(flat_bases) < k:
            return HostKmerDict(np.zeros((0, W), dtype=np.uint32),
                                np.zeros(0, np.int32), np.zeros(0, np.uint32), k)
        lib = _native_count_lib()
        if lib is None:
            raise RuntimeError(
                "count_kmers_flat(host=True) needs the native leaf "
                "native/count_kernel.cc, which did not build (g++ missing?); "
                "the port has no other host count"
            )
        return _count_kmers_flat_native(lib, flat_bases, seg_offsets, k, W, min_freq)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if chunk_pos is None:
        chunk_pos = (1 << 21) if k <= 64 else (1 << 19)
    flat_bases = np.asarray(flat_bases, dtype=np.uint8)
    seg_offsets = np.asarray(seg_offsets, dtype=np.int64)
    T = len(flat_bases)
    if T < k:
        return empty_dict(k, dev)
    n_pos = T - k + 1
    # segment bounds of every position (host, :718-721)
    seg_of = np.searchsorted(seg_offsets, np.arange(n_pos), side="right") - 1
    seg_end = seg_offsets[seg_of + 1]
    seg_start = seg_offsets[seg_of]

    def host(st):
        return _flat_chunk_host(flat_bases, seg_start, seg_end, st,
                                min(chunk_pos, n_pos - st), k)

    def kmerize_of(inputs):
        packed, rows = inputs
        return kmerize_flat(bk.from_raw32(packed), rows[0].bool(), rows[1].bool(),
                            rows[2].bool(), rows[3].to(torch.int64), rows[4].to(torch.int64), k)

    if mesh is not None:
        chunk_pos = shard_chunk(chunk_pos, n_pos, mesh)
        starts = range(0, n_pos, chunk_pos)
        chunks = _round_robin([
            (s, _prefetched(host, starts[s :: mesh.size], mesh.devices[s], mesh.shard_streams[s]))
            for s in range(min(mesh.size, len(starts)))])
        return _count_exchanged(chunks, kmerize_of, mesh, W, k, min_freq, span, stats)[0]
    stream = Stream(n_pos, W, k, sort_backend(), dev)
    with timed(f"{span}.kmerize", dev):
        for inputs in _prefetched(host, range(0, n_pos, chunk_pos), dev):
            stream.put(*kmerize_of(inputs))
    return count_epilogues([stream], k, min_freq, span)[0][0]


# ---------------------------------------------------------------------------
# host counting (step 5's blob-local graphs; kmer_engine.py:381-447,
# :459-475, :836-885, copied)
# ---------------------------------------------------------------------------


def _vview(words):
    """(M, W) uint32 -> (M,) big-endian void view (memcmp == lexicographic)."""
    be = np.ascontiguousarray(words.astype(">u4"))
    return be.view(f"V{4 * words.shape[1]}").reshape(-1)


def host_merge_sorted(a, b):
    """Merge two sorted-unique (words, ctx, cnt) runs on host (numpy).
    Counts saturate at 255 like the reference's combine_Entries
    (BuildReadQGraph.cc:948)."""
    wA, cA, nA = a
    wB, cB, nB = b
    if wA.shape[0] == 0:
        return wB, cB, nB
    if wB.shape[0] == 0:
        return wA, cA, nA
    vA = _vview(wA)
    vB = _vview(wB)
    pos = np.searchsorted(vA, vB)
    posc = np.minimum(pos, len(vA) - 1)
    eq = (pos < len(vA)) & (vA[posc] == vB)

    ctxA = cA.copy()
    cntA = nA.copy()
    hit = posc[eq]
    ctxA[hit] |= cB[eq]
    cntA[hit] = np.minimum(cntA[hit].astype(np.int64) + nB[eq], 255).astype(
        cntA.dtype
    )

    unm = ~eq
    n_un = int(unm.sum())
    if n_un == 0:
        return wA, ctxA, cntA
    posu = pos[unm]  # nondecreasing
    a_dst = np.arange(len(vA)) + np.searchsorted(
        posu, np.arange(len(vA)), side="right"
    )
    b_dst = posu + np.arange(n_un)
    n_out = len(vA) + n_un
    wO = np.empty((n_out, wA.shape[1]), dtype=np.uint32)
    cO = np.empty(n_out, dtype=cA.dtype)
    nO = np.empty(n_out, dtype=nA.dtype)
    wO[a_dst] = wA
    cO[a_dst] = ctxA
    nO[a_dst] = cntA
    wO[b_dst] = wB[unm]
    cO[b_dst] = cB[unm]
    nO[b_dst] = nB[unm]
    return wO, cO, nO


def _host_merge_all(runs):
    """Balanced pairwise host merge of sorted-unique runs."""
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(host_merge_sorted(runs[i], runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _native_count_lib():
    """The C++ leaf counter (native/count_kernel.cc), or None when it
    does not build."""
    from .. import native

    return native.load("w2rapcount", ["count_kernel.cc"], libs=["pthread"])


def _count_kmers_flat_native(lib, flat_bases, seg_offsets, k, W, min_freq):
    """C++ leaf counting over segment batches + the host merge; kmers
    never span segments, so batching by whole segments is exact."""
    import ctypes

    flat = np.ascontiguousarray(flat_bases, dtype=np.uint8)
    seg = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    seg_len = np.diff(seg)
    pos = np.maximum(seg_len - k + 1, 0).astype(np.int64)
    S = len(seg) - 1
    MAXP = 4 << 20
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.w2rap_count_leaf_flat.restype = ctypes.c_int64
    runs = []
    i = 0
    while i < S:
        j = i
        tot = 0
        while j < S and (tot == 0 or tot + pos[j] <= MAXP):
            tot += int(pos[j])
            j += 1
        if tot == 0:
            i = j
            continue
        base = int(seg[i])
        lseg = (seg[i : j + 1] - base).astype(np.int64)
        sub = np.ascontiguousarray(flat[base : int(seg[j])])
        cap = tot
        out_w = np.empty((cap, W), dtype=np.uint32)
        out_x = np.empty(cap, dtype=np.uint8)
        out_c = np.empty(cap, dtype=np.uint8)
        m = lib.w2rap_count_leaf_flat(
            sub.ctypes.data_as(u8p),
            lseg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(j - i), ctypes.c_int32(k), ctypes.c_int32(W),
            out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            out_x.ctypes.data_as(u8p), out_c.ctypes.data_as(u8p),
        )
        runs.append((out_w[:m].copy(), out_x[:m].copy(), out_c[:m].copy()))
        i = j
    if not runs:
        empty = np.zeros((0, W), dtype=np.uint32)
        return HostKmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k)
    words, ctx, cnt = _host_merge_all(runs)
    keep = cnt >= min_freq
    return HostKmerDict(
        words[keep], cnt[keep].astype(np.int32), ctx[keep].astype(np.uint32), k
    )
