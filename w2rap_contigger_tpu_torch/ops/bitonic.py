"""K3a/K3b: bitonic sort of a kmer stream (W2RAP_SORT=pallas).

`bitonic_sort` runs the CUDA kernels of csrc/bitonic_tile.cu (K3a) and
csrc/bitonic.cu (the cross stage and K3b), which replace
the TPU kernels of w2rap_contigger_tpu/ops/pallas_sort.py (`bitonic_sort`
:258, `_sort_planes` :206-255); `bitonic_sort_plain` is the same network
in plain PyTorch, and the wrapper takes it only for tensors on the CPU.

Contract of bitonic_sort(planes, num_keys, tile_rows) on (num_ops, n)
int32 planes of raw u32 bits, n a power of two >= 128 (JAX's): the first
num_keys planes are key words, most significant first, compared
unsigned; the others ride along; a row all ones in its key words is a
sentinel and sorts last.  The network is the canonical one: for size =
2, 4, ..., n and stride s = size/2, ..., 1 the pair (i, i+s) with
i & s == 0 is swapped iff (row i > row i+s) XOR ((i & size) != 0).  The
sort is not stable, but equal keys swap by that rule in descending
blocks, so the order of tied rows (payload included) is one fixed
function of the input: the kernels, the plain version and the JAX
function agree bit for bit, whatever tile each uses.

The network in phases, each a function of its own with its kernel and
plain version side by side; the phase wrappers take CUDA tensors only and
sort in place, as bitonic_sort does (it alone routes CPU tensors to the
plain version, which returns a new tensor):

  tile_sort   (K3a)  levels 2..T inside every tile of T rows, as a
                     key-index network: only (row index, first key
                     word) pairs move, R a thread (tile_geometry), the
                     planes sit still in shared memory and move once;
  cross_stage        one stride >= T of a merge level (XLA in JAX,
                     _cross_stage :183; a kernel here: torch would need
                     about 3 (W+1) launches a stride);
  merge_level (K3b)  strides T/2..1 of one merge level inside every tile.

The port's tile is the largest power of two whose rows fit in 160 KB of
one block's shared memory (8192 rows at 4 key words + payload, 2048 at
17 + payload); JAX's is 512 * 128 rows of VMEM.  The network is the same.
"""

from __future__ import annotations

import torch

from .. import device as tdev
from . import _build
from . import bitkmer as bk

LANES = 128
TILE_BYTES = 160 * 1024  # a default tile's rows in one block's shared memory
SMEM_MAX_BYTES = 232_448  # the most shared memory a block may opt in to
TILE_THREADS = 1024  # K3a: the most threads a block


# ---------------------------------------------------------------------------
# geometry and checks
# ---------------------------------------------------------------------------


def tile_rows_of(num_ops: int, n: int, tile_rows: int | None = None) -> int:
    """Rows T of a tile: tile_rows * 128, or by default the largest power
    of two whose num_ops planes fit TILE_BYTES; never above n."""
    if tile_rows is None:
        T = LANES
        while 2 * T * num_ops * 4 <= TILE_BYTES:
            T *= 2
    else:
        T = tile_rows * LANES
        if T <= 0 or T & (T - 1):
            raise ValueError(f"tile of {T} rows: must be a power of two")
    return min(T, n)


def tile_geometry(T: int, num_ops: int) -> dict:
    """Launch geometry of K3a on T-row tiles of num_ops planes: R rows a
    thread (the least of 2, 4, 8, 16 that keeps T / R <= 1024 threads:
    more threads hide more latency, and R = 2 beat 4 and 8 at T = 2048,
    `scripts/sort_kernel_ab.py`), threads = T / R (at least a
    warp), and the dynamic shared memory: the planes plus two u16 index
    buffers.  Strides below R run in registers, R..16R by warp shuffles,
    32R and above through shared memory."""
    R = max(2, T // TILE_THREADS)
    smem = num_ops * T * 4 + 4 * T
    if T & (T - 1) or R not in (2, 4, 8, 16) or not 32 <= T // R <= TILE_THREADS:
        raise ValueError(f"K3a: a tile of {T} rows at {R} a thread")
    if smem > SMEM_MAX_BYTES:
        raise ValueError(
            f"K3a: a tile of {T} rows x {num_ops} planes and its indices need "
            f"{smem} bytes, more than one block's {SMEM_MAX_BYTES}"
        )
    return {"R": R, "threads": T // R, "smem_bytes": smem}


def _check(planes: torch.Tensor, num_keys: int) -> int:
    if planes.dtype != torch.int32 or planes.dim() != 2:
        raise ValueError(
            f"bitonic_sort takes (num_ops, n) int32 planes, got "
            f"{planes.dtype} {tuple(planes.shape)}"
        )
    if not 1 <= num_keys <= planes.shape[0]:
        raise ValueError(f"num_keys {num_keys} outside 1..{planes.shape[0]}")
    n = planes.shape[1]
    if n < LANES or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two >= {LANES}")
    return n


def _launch_ready(planes: torch.Tensor, num_keys: int, T: int | None = None) -> None:
    """Checks of a phase wrapper (the kernels sort planes in place)."""
    _check(planes, num_keys)
    if planes.device.type != "cuda":
        raise ValueError(f"bitonic kernels: unsupported device {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("bitonic kernels take contiguous planes")
    if T is not None:
        n = planes.shape[1]
        if T < 2 or T & (T - 1) or T > n:
            raise ValueError(f"tile of {T} rows: a power of two <= n={n}")
        if planes.shape[0] * T * 4 > SMEM_MAX_BYTES:
            raise ValueError(
                f"a tile of {T} rows x {planes.shape[0]} planes does not fit "
                f"one block's {SMEM_MAX_BYTES} bytes of shared memory"
            )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def phases(n: int, T: int) -> list[tuple[str, int, int]]:
    """The network as phases (kind, stride or T, level size), in order:
    the tile sort, then per merge level its cross strides and its merge
    (_sort_planes :220-254)."""
    out = [("tile", T, T)]
    size = 2 * T
    while size <= n:
        s = size // 2
        while s >= T:
            out.append(("cross", s, size))
            s //= 2
        out.append(("merge", T, size))
        size *= 2
    return out


def _stages(kind: str, x: int, size: int) -> list[tuple[int, int]]:
    """(stride, level size) of every compare-exchange stage of a phase."""
    if kind == "cross":
        return [(x, size)]
    levels = [1 << i for i in range(1, x.bit_length())] if kind == "tile" else [size]
    return [(s, lv) for lv in levels
            for s in (1 << i for i in range(min(lv, x).bit_length() - 2, -1, -1))]


# ---------------------------------------------------------------------------
# plain PyTorch: the network on order-preserving int64 keys + row index
# ---------------------------------------------------------------------------


def _keys(planes: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(ceil(num_keys / 2), n) int64 keys whose signed order is the rows'
    unsigned lexicographic order: two u32 words each."""
    words = [bk.from_raw32(planes[j]) for j in range(num_keys)]
    keys = [bk.pair_key(words[j], words[j + 1]) for j in range(0, num_keys - 1, 2)]
    if num_keys % 2:
        keys.append(words[-1])
    return torch.stack(keys)


def _stage(keys: torch.Tensor, idx: torch.Tensor, s: int, size: int):
    """One compare-exchange stage at stride s of level size."""
    K, n = keys.shape
    g = n // (2 * s)
    kv = keys.view(K, g, 2, s)
    a, b = kv[:, :, 0], kv[:, :, 1]
    gt = a[K - 1] > b[K - 1]
    for j in range(K - 2, -1, -1):
        gt = (a[j] > b[j]) | ((a[j] == b[j]) & gt)
    # s < size: bit `size` of i = g * 2s + r (r < s) is bit `size` of g * 2s
    desc = ((torch.arange(g, device=keys.device) * (2 * s)) & size) != 0
    swap = (gt ^ desc[:, None])[:, None, :]  # (g, 1, s) over the pair axis
    keys = torch.where(swap, kv.flip(2), kv).view(K, n)
    iv = idx.view(g, 2, s)
    return keys, torch.where(swap, iv.flip(1), iv).view(n)


def _network_plain(planes: torch.Tensor, num_keys: int, stages) -> torch.Tensor:
    n = _check(planes, num_keys)
    keys = _keys(planes, num_keys)
    idx = torch.arange(n, device=planes.device)
    for s, size in stages:
        keys, idx = _stage(keys, idx, s, size)
    return planes[:, idx]


def tile_sort_plain(planes: torch.Tensor, num_keys: int, T: int) -> torch.Tensor:
    """Levels 2..T of the network inside every tile of T rows."""
    return _network_plain(planes, num_keys, _stages("tile", T, T))


def cross_stage_plain(planes: torch.Tensor, num_keys: int, s: int, size: int) -> torch.Tensor:
    """One compare-exchange stage at stride s of level size."""
    return _network_plain(planes, num_keys, _stages("cross", s, size))


def merge_level_plain(planes: torch.Tensor, num_keys: int, T: int, size: int) -> torch.Tensor:
    """Strides T/2..1 of level size inside every tile of T rows."""
    return _network_plain(planes, num_keys, _stages("merge", T, size))


def bitonic_sort_plain(planes: torch.Tensor, num_keys: int,
                       tile_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch bitonic sort on any device (the CPU's path): the
    phases of bitonic_sort, run as one chain of stages."""
    n = _check(planes, num_keys)
    T = tile_rows_of(planes.shape[0], n, tile_rows)
    stages = [st for ph in phases(n, T) for st in _stages(*ph)]
    return _network_plain(planes, num_keys, stages)


# ---------------------------------------------------------------------------
# the kernels (CUDA tensors only)
# ---------------------------------------------------------------------------


def tile_sort(planes: torch.Tensor, num_keys: int, T: int) -> torch.Tensor:
    """K3a on CUDA tensors, in place (tile_sort_plain is the plain version)."""
    _launch_ready(planes, num_keys, T)
    if planes.data_ptr() % 16:
        raise ValueError("K3a takes 16-byte aligned planes (16 B vector loads)")
    g = tile_geometry(T, planes.shape[0])
    err = _build.library().w2rap_bitonic_tile_sort(
        planes.data_ptr(), planes.shape[1], planes.shape[0], num_keys, T,
        g["R"], g["threads"], g["smem_bytes"], _stream(planes),
    )
    _build.check(err, "w2rap_bitonic_tile_sort")
    tdev.count_launch("bitonic_tile_sort")
    return planes


def tile_sort_attrs(R: int) -> dict:
    """Registers, spills and static shared memory of K3a's kernel for R."""
    return _build.kernel_attrs("w2rap_bitonic_tile_sort_attrs", R)


def cross_stage(planes: torch.Tensor, num_keys: int, s: int, size: int) -> torch.Tensor:
    """One stride of a merge level on CUDA tensors, in place
    (cross_stage_plain is the plain version)."""
    _launch_ready(planes, num_keys)
    if s < 1 or s & (s - 1) or size & (size - 1) or not s < size <= planes.shape[1]:
        raise ValueError(f"stride {s} of level {size}: powers of two, s < size <= n")
    err = _build.library().w2rap_bitonic_cross_stage(
        planes.data_ptr(), planes.shape[1], planes.shape[0], num_keys, s, size,
        _stream(planes),
    )
    _build.check(err, "w2rap_bitonic_cross_stage")
    tdev.count_launch("bitonic_cross_stage")
    return planes


def merge_level(planes: torch.Tensor, num_keys: int, T: int, size: int) -> torch.Tensor:
    """K3b on CUDA tensors, in place (merge_level_plain is the plain
    version)."""
    _launch_ready(planes, num_keys, T)
    if size & (size - 1) or not T < size <= planes.shape[1]:
        raise ValueError(f"merge level {size}: a power of two in ({T}, n]")
    err = _build.library().w2rap_bitonic_merge(
        planes.data_ptr(), planes.shape[1], planes.shape[0], num_keys, T, size,
        _stream(planes),
    )
    _build.check(err, "w2rap_bitonic_merge")
    tdev.count_launch("bitonic_merge")
    return planes


def bitonic_sort(planes: torch.Tensor, num_keys: int,
                 tile_rows: int | None = None) -> torch.Tensor:
    """K3: sorts planes in place and returns them; the CUDA kernels for
    CUDA tensors, the plain version (copied back) for CPU tensors."""
    if planes.device.type == "cpu":
        return planes.copy_(bitonic_sort_plain(planes, num_keys, tile_rows))
    n = _check(planes, num_keys)
    T = tile_rows_of(planes.shape[0], n, tile_rows)
    for kind, x, size in phases(n, T):
        if kind == "tile":
            tile_sort(planes, num_keys, T)
        elif kind == "cross":
            cross_stage(planes, num_keys, x, size)
        else:
            merge_level(planes, num_keys, T, size)
    return planes
