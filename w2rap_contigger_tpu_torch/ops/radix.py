"""K4a-d: partition (sample) sort of a kmer stream.

`partition_sort` runs the CUDA kernels of csrc/radix.cu (K4a, K4b, K4d)
and csrc/region_merge.cu (K4c), which replace the TPU kernels of
w2rap_contigger_tpu/ops/pallas_radix.py (`partition_sort` :482-520,
`_partition_sort_planes` :330-457); `partition_sort_plain` is the same
function in plain PyTorch, and the wrapper takes it only for tensors on
the CPU.  `collision_flag` is plain torch, as it is XLA in JAX (:460-479).

Contract of partition_sort(planes, num_keys, cmp_keys, tile_rows, n_bins)
on (num_ops, n) int32 planes of raw u32 bits (the first num_keys are key
words, most significant first; a row all ones in them is a sentinel):

* the output is n_bins regions of n_tiles * cap rows back to back
  (T = tile_rows * 128 rows a tile, n_tiles = n / T, cap = CAP_FACTOR *
  T // n_bins); region b holds its valid rows first, ascending on the
  first cmp_keys words and stable (input order) among ties, then
  sentinels (all ones in key planes, 0 in payload planes);
* the splitters are JAX's: the keys at positions t*T + b*(T//n_bins) - 1
  of the sorted tiles, sorted, every n_tiles-th one (:362-372);
* the overflow count is JAX's: slots of more than cap - 128 rows, plus
  real rows whose cmp_keys words are all ones when cmp_keys < num_keys
  (:252-275, :306-311), with n_bins halved until cap is a multiple of
  1024 (:506-511).  Nonzero means the caller must recount exactly.

Only the order of rows that tie on the first cmp_keys words may differ
from the bitonic network's; the port defines it as stable, so the kernel
and its plain version agree bit for bit.  The port also takes any number
of whole tiles (the bitonic network needed a power of two), and cmp_keys
up to 4 (128 bits).

Each phase is a function of its own, kernel and plain version side by
side, so every kernel can be held against its plain version alone; the
phase wrappers take CUDA tensors only (partition_sort alone routes CPU
tensors to the plain version):

  tile_sort   (K4a)  planes -> records (hi, lo, idx) sorted per tile;
  splitters          sorted records -> (n_bins - 1) splitter keys (torch);
  partition   (K4b)  sorted records -> per-(bin, tile) slots + overflow;
                     every slot a sorted run: a tile's rows, then fill;
  region_sort (K4c)  every C-record chunk of a region, made of sorted runs
                     of `run` = min(cap, C) records (K4b's slots), merged
                     into one sorted run (merge path in shared memory,
                     log2(C / run) levels; region_merge_geometry);
  merge_pass  (K4d)  one merge level of runs of `width` records;
  gather             records -> the output planes (fused into the last
                     kernel on the card).

A record is hi = w0 << 32 | w1, lo = w2 << 32 | w3 over the first
cmp_keys words (missing words 0), as int64 tensors holding u64 bits, and
idx, the input row (int32 holding u32 bits; fill records carry ~0 in
all three).  Records order on (hi, lo, idx) unsigned.
"""

from __future__ import annotations

import torch

from .. import device as tdev
from . import _build
from . import bitkmer as bk

LANES = 128
MAX_CMP_KEYS = 4
MAX_TILE = 8192  # records a block sorts in shared memory (20 B each)

# tile_rows * 128 rows a tile; the port's default tile is the largest
# that fits one block's shared memory (8192 records, 160 KB)
DEFAULT_TILE_ROWS = 64
DEFAULT_REGION_ROWS = 1024  # target region rows / 128 for the default n_bins
CAP_FACTOR = 2  # slot capacity = CAP_FACTOR * tile / bins
MERGE_OUTPUTS = 8  # K4c: records a thread merges per level (P, region_merge.cu)
MAX_RUNS = 64  # K4c: sorted runs a chunk may hold
RECORD_BYTES = 20  # hi, lo, idx (records.cuh)

SIGN64 = -(1 << 63)  # xor flips u64 bits held in int64 into signed order
FILL_IDX = -1  # u32 0xFFFFFFFF


# ---------------------------------------------------------------------------
# geometry and checks
# ---------------------------------------------------------------------------


def geometry(n: int, tile_rows: int | None = None, n_bins: int | None = None):
    """(T, n_tiles, n_bins, cap, region) of a partition sort of n rows,
    with JAX's default bin count and halving rule (:499-511)."""
    if tile_rows is None:
        tile_rows = DEFAULT_TILE_ROWS
    T = tile_rows * LANES
    if T > MAX_TILE or T & (T - 1):
        raise ValueError(f"tile of {T} rows: must be a power of two <= {MAX_TILE}")
    if n <= 0 or n % T:
        raise ValueError(f"{n} rows: must be a positive multiple of the tile {T}")
    n_tiles = n // T
    if n_bins is None:
        target = CAP_FACTOR * n // (DEFAULT_REGION_ROWS * LANES)
        n_bins = max(8, 1 << max(target, 1).bit_length() - 1)
    while n_bins > 1 and (CAP_FACTOR * T // n_bins) % (8 * LANES):
        n_bins //= 2
    cap = CAP_FACTOR * T // n_bins
    return T, n_tiles, n_bins, cap, n_tiles * cap


def region_merge_geometry(C: int, run: int) -> dict:
    """Launch geometry of K4c on chunks of C records made of sorted runs
    of `run`: m (the power of two >= C the chunk is padded to with fill),
    the merge levels log2(m / run), P records a thread merges per level,
    threads = m / P, and the dynamic shared memory (20 B a record)."""
    P = MERGE_OUTPUTS
    m = 1 << max(C - 1, 0).bit_length()
    if not 0 < run <= m or run & (run - 1):
        raise ValueError(f"K4c geometry: run {run}, C {C}")
    if m > MAX_TILE or m // run > MAX_RUNS or m < P:
        raise ValueError(f"K4c geometry: a chunk of {C} records in runs of {run}")
    return {"m": m, "run": run, "levels": (m // run).bit_length() - 1, "P": P,
            "threads": m // P, "smem_bytes": m * RECORD_BYTES}


def _check(planes: torch.Tensor, num_keys: int, cmp_keys: int) -> int:
    if planes.dtype != torch.int32 or planes.dim() != 2:
        raise ValueError(
            f"partition_sort takes (num_ops, n) int32 planes, got "
            f"{planes.dtype} {tuple(planes.shape)}"
        )
    if not 1 <= num_keys <= planes.shape[0]:
        raise ValueError(f"num_keys {num_keys} outside 1..{planes.shape[0]}")
    cmp_keys = min(cmp_keys, num_keys)
    if not 1 <= cmp_keys <= MAX_CMP_KEYS:
        raise ValueError(f"cmp_keys {cmp_keys} outside 1..{MAX_CMP_KEYS}")
    return cmp_keys


def _launch_ready(*tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"radix kernels: unsupported device {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("radix kernels take contiguous tensors on one device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# records in plain torch
# ---------------------------------------------------------------------------


def _records(planes: torch.Tensor, cmp_keys: int):
    """(hi, lo) int64 u64 bits of every row's first cmp_keys words."""
    w = [bk.from_raw32(planes[j]) if j < cmp_keys else None for j in range(4)]
    zero = torch.zeros_like(w[0])

    def pair(a, b):
        a = zero if a is None else a
        b = zero if b is None else b
        return (a << 32) | b  # int64 wraparound keeps the u64 bits

    return pair(w[0], w[1]), pair(w[2], w[3])


def _order(*keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rows by keys (most significant first),
    each key an int64 tensor compared as signed."""
    perm = None
    for key in reversed(keys):
        kk = key if perm is None else key[perm]
        _, idx = torch.sort(kk, stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


def u64_order(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u64 bits -> int64 in the same (signed) order."""
    return x ^ SIGN64


def _u32(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int64) & bk.FULL


# ---------------------------------------------------------------------------
# K4a: tile sort
# ---------------------------------------------------------------------------


def tile_sort_plain(planes: torch.Tensor, cmp_keys: int, T: int):
    """Records of every T-row tile, each tile sorted (plain torch)."""
    n = planes.shape[1]
    hi, lo = _records(planes, cmp_keys)
    row = torch.arange(n, device=planes.device)
    perm = _order(row // T, u64_order(hi), u64_order(lo))  # stable: row order in ties
    return hi[perm], lo[perm], perm.to(torch.int32)


def tile_sort(planes: torch.Tensor, cmp_keys: int, T: int):
    """K4a on CUDA tensors (tile_sort_plain is the plain version)."""
    _launch_ready(planes)
    n = planes.shape[1]
    hi = torch.empty(n, dtype=torch.int64, device=planes.device)
    lo = torch.empty_like(hi)
    idx = torch.empty(n, dtype=torch.int32, device=planes.device)
    err = _build.library().w2rap_radix_tile_sort(
        planes.data_ptr(), n, cmp_keys, T, hi.data_ptr(), lo.data_ptr(),
        idx.data_ptr(), _stream(planes),
    )
    _build.check(err, "w2rap_radix_tile_sort")
    tdev.count_launch("radix_tile_sort")
    return hi, lo, idx


# ---------------------------------------------------------------------------
# splitters (XLA in JAX: plain torch on every device)
# ---------------------------------------------------------------------------


def splitters(hi: torch.Tensor, lo: torch.Tensor, T: int, n_bins: int):
    """(n_bins - 1,) splitter keys (hi, lo) from the sorted tiles: keys at
    t*T + b*(T//n_bins) - 1 (b = 1..n_bins-1), sorted, every n_tiles-th
    (pallas_radix.py:362-372)."""
    n_tiles = hi.shape[0] // T
    dev = hi.device
    b = torch.arange(1, n_bins, device=dev)
    t = torch.arange(n_tiles, device=dev)
    pos = (t[:, None] * T + b[None, :] * (T // n_bins) - 1).reshape(-1)
    s_hi, s_lo = hi[pos], lo[pos]
    perm = _order(u64_order(s_hi), u64_order(s_lo))
    sel = b * n_tiles - 1
    return s_hi[perm][sel].contiguous(), s_lo[perm][sel].contiguous()


# ---------------------------------------------------------------------------
# K4b: partition into slots
# ---------------------------------------------------------------------------


def _fill(total: int, dev):
    hi = torch.full((total,), -1, dtype=torch.int64, device=dev)
    return hi, hi.clone(), torch.full((total,), FILL_IDX, dtype=torch.int32, device=dev)


def partition_plain(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys: int,
                    cmp_keys: int, T: int, n_bins: int, cap: int):
    """Slots of every sorted tile (plain torch): records (n_bins * region,)
    and the overflow count, an int32 tensor of one element."""
    n = planes.shape[1]
    dev = planes.device
    n_tiles = n // T
    region = n_tiles * cap
    cmp_full = (planes[:cmp_keys] == -1).all(dim=0)
    sent = cmp_full & (planes[cmp_keys:num_keys] == -1).all(dim=0)
    tile = torch.arange(n, device=dev) // T
    n_valid = T - torch.bincount(tile[sent], minlength=n_tiles)
    starts = torch.zeros((n_tiles, n_bins + 1), dtype=torch.int64, device=dev)
    hs, ls = u64_order(s_hi), u64_order(s_lo)
    for b in range(n_bins - 1):
        kh, kl = u64_order(sp_hi[b]), u64_order(sp_lo[b])
        lt = (hs < kh) | ((hs == kh) & (ls < kl))
        starts[:, b + 1] = torch.bincount(tile[lt], minlength=n_tiles)
    starts[:, n_bins] = n_valid
    cnt = starts[:, 1:] - starts[:, :-1]  # (n_tiles, n_bins)
    overflow = (cnt > cap - 128).sum()
    if cmp_keys < num_keys:
        overflow += (cmp_full & ~sent).sum()
    take = cnt.clamp(0, cap)

    r_hi, r_lo, r_idx = _fill(n_bins * region, dev)
    m = int(take.sum())
    if m:
        t_of = torch.arange(n_tiles, device=dev)[:, None].expand(-1, n_bins)
        b_of = torch.arange(n_bins, device=dev)[None, :].expand(n_tiles, -1)
        flat_take = take.reshape(-1)
        first = torch.cumsum(flat_take, 0) - flat_take
        j = torch.arange(m, device=dev) - torch.repeat_interleave(first, flat_take, output_size=m)
        rep = lambda x: torch.repeat_interleave(x.reshape(-1), flat_take, output_size=m)  # noqa: E731
        src = rep(t_of) * T + rep(starts[:, :-1]) + j
        dst = rep(b_of) * region + rep(t_of) * cap + j
        r_hi[dst], r_lo[dst], r_idx[dst] = s_hi[src], s_lo[src], s_idx[src]
    return r_hi, r_lo, r_idx, overflow.to(torch.int32).reshape(1)


def partition(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys: int,
              cmp_keys: int, T: int, n_bins: int, cap: int):
    """K4b on CUDA tensors (partition_plain is the plain version)."""
    _launch_ready(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo)
    n = planes.shape[1]
    region = (n // T) * cap
    r_hi, r_lo, r_idx = (torch.empty(n_bins * region, dtype=d, device=planes.device)
                         for d in (torch.int64, torch.int64, torch.int32))
    overflow = torch.zeros(1, dtype=torch.int32, device=planes.device)
    err = _build.library().w2rap_radix_partition(
        planes.data_ptr(), n, num_keys, cmp_keys, T, n_bins, cap,
        sp_hi.data_ptr(), sp_lo.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(),
        s_idx.data_ptr(), r_hi.data_ptr(), r_lo.data_ptr(), r_idx.data_ptr(),
        region, overflow.data_ptr(), _stream(planes),
    )
    _build.check(err, "w2rap_radix_partition")
    tdev.count_launch("radix_partition")
    return r_hi, r_lo, r_idx, overflow


# ---------------------------------------------------------------------------
# K4c: chunk sort of the regions; K4d: merge levels; the gather
# ---------------------------------------------------------------------------


def _sort_blocks(r_hi, r_lo, r_idx, block_of):
    perm = _order(block_of, u64_order(r_hi), u64_order(r_lo), _u32(r_idx))
    return r_hi[perm], r_lo[perm], r_idx[perm]


def region_sort_plain(r_hi, r_lo, r_idx, region: int, C: int):
    """Every C-record chunk of every region sorted (plain torch)."""
    p = torch.arange(r_hi.shape[0], device=r_hi.device)
    chunk = (p // region) * region + (p % region) // C * C
    return _sort_blocks(r_hi, r_lo, r_idx, chunk)


def merge_pass_plain(r_hi, r_lo, r_idx, region: int, width: int):
    """Sorted runs of `width` records merged pairwise in every region
    (plain torch: a stable sort of each pair of runs)."""
    p = torch.arange(r_hi.shape[0], device=r_hi.device)
    pair = (p // region) * region + (p % region) // (2 * width) * (2 * width)
    return _sort_blocks(r_hi, r_lo, r_idx, pair)


def gather_plain(r_idx, planes, num_keys: int):
    """Output planes of the records: each row's planes through idx; fill
    records become all ones in key planes and 0 in payload planes."""
    fill = r_idx == FILL_IDX
    src = _u32(r_idx).masked_fill(fill, 0)
    out = planes[:, src]
    out[:num_keys, fill] = -1
    out[num_keys:, fill] = 0
    return out


def merge_widths(region: int, C: int) -> list[int]:
    """Run widths of the merge levels after the C-record chunk sort."""
    widths = []
    w = C
    while w < region:
        widths.append(w)
        w *= 2
    return widths


def region_sort(r_hi, r_lo, r_idx, region: int, C: int, run: int, final=None):
    """K4c on CUDA tensors (region_sort_plain, then gather_plain, is the
    plain version): every C-record chunk of a region, which must consist
    of sorted runs of `run` records (K4b's slots), merged into one sorted
    run.  final = (planes, num_keys): gather the output planes
    (num_ops, total) instead of returning records."""
    g = region_merge_geometry(C, run)
    return _launch_records("region_sort", (r_hi, r_lo, r_idx),
                           (region, C, run, g["m"], g["threads"]), final)


def region_sort_attrs() -> dict:
    """Registers, spills and static shared memory of K4c's kernel."""
    return _build.kernel_attrs("w2rap_radix_region_sort_attrs")


def merge_pass(r_hi, r_lo, r_idx, region: int, width: int, final=None):
    """K4d on CUDA tensors, one merge level (merge_pass_plain, then
    gather_plain, is the plain version).  final = (planes, num_keys):
    gather the output planes instead of returning records."""
    return _launch_records("merge_pass", (r_hi, r_lo, r_idx), (region, width), final)


def _launch_records(name: str, recs, geom, final):
    """Launch K4c or K4d: records -> records, or (final) -> gathered planes."""
    _launch_ready(*recs)
    total = recs[0].shape[0]
    dev = recs[0].device
    if final:
        planes, num_keys = final
        _launch_ready(planes, recs[0])
        out = torch.empty((planes.shape[0], total), dtype=torch.int32, device=dev)
        dst = (None, None, None)
        gather = (planes.data_ptr(), planes.shape[1], planes.shape[0], num_keys,
                  out.data_ptr())
    else:
        out = tuple(torch.empty_like(r) for r in recs)
        dst = tuple(r.data_ptr() for r in out)
        gather = (None, 0, 0, 0, None)
    fn = getattr(_build.library(), f"w2rap_radix_{name}")
    err = fn(*(r.data_ptr() for r in recs), *dst, total, *geom, int(bool(final)),
             *gather, _stream(recs[0]))
    _build.check(err, f"w2rap_radix_{name}")
    tdev.count_launch(f"radix_{name}")
    return out


# ---------------------------------------------------------------------------
# the whole sort
# ---------------------------------------------------------------------------


def _partition_sort(planes, num_keys, cmp_keys, tile_rows, n_bins, plain):
    cmp_keys = _check(planes, num_keys, cmp_keys)
    T, n_tiles, n_bins, cap, region = geometry(planes.shape[1], tile_rows, n_bins)
    k4a, k4b = (tile_sort_plain, partition_plain) if plain else (tile_sort, partition)
    s_hi, s_lo, s_idx = k4a(planes, cmp_keys, T)
    sp_hi, sp_lo = splitters(s_hi, s_lo, T, n_bins)
    *recs, overflow = k4b(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys,
                          cmp_keys, T, n_bins, cap)
    del s_hi, s_lo, s_idx
    if plain:  # one stable sort per region computes what K4c + K4d do
        p = torch.arange(recs[0].shape[0], device=planes.device)
        recs = _sort_blocks(*recs, p // region * region)
        return gather_plain(recs[2], planes, num_keys), overflow
    final = (planes, num_keys)
    C = min(T, region)
    widths = merge_widths(region, C)
    recs = region_sort(*recs, region, C, min(cap, C), final=None if widths else final)
    for i, w in enumerate(widths):
        recs = merge_pass(*recs, region, w, final=final if i == len(widths) - 1 else None)
    return recs, overflow


def partition_sort_plain(planes: torch.Tensor, num_keys: int, cmp_keys: int = 2,
                         tile_rows: int | None = None, n_bins: int | None = None):
    """Plain PyTorch partition sort on any device (the CPU tests' path).
    Returns (out (num_ops, n_bins * region) int32, overflow (1,) int32)."""
    return _partition_sort(planes, num_keys, cmp_keys, tile_rows, n_bins, True)


def partition_sort(planes: torch.Tensor, num_keys: int, cmp_keys: int = 2,
                   tile_rows: int | None = None, n_bins: int | None = None):
    """K4 on the tensors' device: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Returns (out, overflow) as
    partition_sort_plain."""
    if planes.device.type == "cpu":
        return partition_sort_plain(planes, num_keys, cmp_keys, tile_rows, n_bins)
    _launch_ready(planes)
    return _partition_sort(planes, num_keys, cmp_keys, tile_rows, n_bins, False)


def collision_flag(planes: torch.Tensor, num_keys: int, cmp_keys: int = 2) -> torch.Tensor:
    """Adjacent rows equal in the first cmp_keys words but different in a
    later key word (pallas_radix.py:460-479): zero means the cmp_keys-word
    comparator grouped every kmer exactly.  Returns an int64 scalar tensor."""
    if num_keys <= cmp_keys or planes.shape[1] < 2:
        return torch.zeros((), dtype=torch.int64, device=planes.device)
    a, b = planes[:num_keys, 1:], planes[:num_keys, :-1]
    eq = (a[:cmp_keys] == b[:cmp_keys]).all(dim=0)
    differ = (a[cmp_keys:] != b[cmp_keys:]).any(dim=0)
    return (eq & differ).sum()
