"""K2: collapse a sorted kmer stream into per-tile compacted rows.

`collapse` is the wrapper of the CUDA kernel csrc/collapse.cu, which
replaces the TPU kernel w2rap_contigger_tpu/ops/pallas_collapse.py:
_collapse_kernel (:83).  `collapse_plain` is the same function in plain
PyTorch; the wrapper takes it only for tensors on the CPU.

Input: (W+1, n) int32 planes of raw u32 bits, sorted so equal kmers are
adjacent — W word planes and a payload plane (ctx << 8) | cnt; all-ones
rows are sentinels.  Output (identical from both versions):

* out (W+1, n): tile t (rows [t*tile, (t+1)*tile)) holds its kept rows
  at its front, in order — one row per non-sentinel segment whose
  saturated count reaches min_count, carrying the segment's words and
  (ctx OR) << 8 | min(sum cnt, 255) — and sentinel rows (payload 0)
  after them.  A segment belongs to the tile of its last row.
* tile_counts (n_tiles,) int32: each tile's kept rows.
* low_bins (128,) int32: bins 1..min_count-1 count the segments dropped
  by the min_count filter at each count (the histogram's low bins).

ctx is the 8-bit KMerContext: payload bits above 15 are not carried.
"""

from __future__ import annotations

import torch

from .. import device as tdev
from . import _build
from . import bitkmer as bk

TILE = 4096  # rows per CUDA block (a multiple of the kernel's 256 threads)
LOW_BINS = 128


def _check(planes: torch.Tensor, min_count: int, tile: int) -> tuple[int, int]:
    if planes.dtype != torch.int32 or planes.dim() != 2 or planes.shape[0] < 2:
        raise ValueError(f"collapse takes (W+1, n) int32 planes, got {planes.dtype} {tuple(planes.shape)}")
    if not 1 <= min_count < LOW_BINS:
        raise ValueError(f"min_count {min_count} outside 1..{LOW_BINS - 1}")
    if tile <= 0 or tile % 256:
        raise ValueError(f"tile {tile} must be a positive multiple of 256")
    return planes.shape[0] - 1, planes.shape[1]


def collapse_plain(planes: torch.Tensor, min_count: int = 1, tile: int = TILE):
    """Plain PyTorch K2 on any device (the CPU tests' path)."""
    W, n = _check(planes, min_count, tile)
    dev = planes.device
    n_tiles = -(-n // tile)
    if n == 0:
        return planes.clone(), torch.zeros(0, dtype=torch.int32, device=dev), \
            torch.zeros(LOW_BINS, dtype=torch.int32, device=dev)
    words = planes[:W]  # raw bits: equality needs no u32 conversion
    pay = bk.from_raw32(planes[W])
    differs = (words[:, 1:] != words[:, :-1]).any(dim=0)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_start = torch.cat([one, differs])
    is_end = torch.cat([differs, one])
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    n_seg = int(seg[-1]) + 1
    cnt = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    cnt.index_add_(0, seg, pay & 0xFF)
    cnt = cnt.clamp(max=255)
    ctx = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    for b in range(8):
        hit = torch.zeros(n_seg, dtype=torch.int64, device=dev)
        hit.index_add_(0, seg, (pay >> (8 + b)) & 1)
        ctx |= (hit > 0).to(torch.int64) << b
    seg_cnt = cnt[seg]
    sentinel = (words == -1).all(dim=0)
    live = is_end & ~sentinel
    keep = live if min_count <= 1 else live & (seg_cnt >= min_count)

    low = torch.zeros(LOW_BINS, dtype=torch.int64, device=dev)
    dropped = live & ~keep
    low.index_add_(0, seg_cnt[dropped], torch.ones_like(seg_cnt[dropped]))
    low[0] = 0

    rows = torch.arange(n, device=dev)
    tile_of = rows // tile
    kept_rows = rows[keep]
    kept_tile = tile_of[keep]
    tile_counts = torch.bincount(kept_tile, minlength=n_tiles)
    tile_first = torch.cumsum(tile_counts, 0) - tile_counts
    dst = kept_tile * tile + torch.arange(kept_rows.numel(), device=dev) - tile_first[kept_tile]

    out = torch.full((W + 1, n), -1, dtype=torch.int32, device=dev)
    out[W] = 0
    for j in range(W):
        out[j, dst] = planes[j, kept_rows]
    out[W, dst] = bk.to_raw32((ctx[seg[kept_rows]] << 8) | seg_cnt[kept_rows])
    return out, tile_counts.to(torch.int32), low.to(torch.int32)


def collapse(planes: torch.Tensor, min_count: int = 1, tile: int = TILE):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (out, tile_counts, low_bins)."""
    if planes.device.type == "cpu":
        return collapse_plain(planes, min_count, tile)
    W, n = _check(planes, min_count, tile)
    if planes.device.type != "cuda":
        raise ValueError(f"collapse: unsupported device {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("collapse takes contiguous planes")
    dev = planes.device
    n_tiles = -(-n // tile)
    out = torch.empty_like(planes)
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    low_bins = torch.zeros(LOW_BINS, dtype=torch.int32, device=dev)
    if n == 0:
        return out, tile_counts, low_bins
    err = _build.library().w2rap_collapse(
        planes.data_ptr(), n, W, min_count, tile, out.data_ptr(),
        tile_counts.data_ptr(), low_bins.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "w2rap_collapse")
    tdev.count_launch("collapse")
    return out, tile_counts, low_bins
