"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--work DIR]   # needs one NVIDIA GPU

Phases, each printing its results on a line of its own; any failure
exits non-zero and prints no result line:

1. probe the card (torch.cuda, nvidia-smi name and power limit);
2. build the CUDA kernels from csrc/ with nvcc;
3. each kernel against its plain PyTorch version, element by element, on
   the card at the main path's shapes (K1 kmerize on one 65536-read chunk
   at k=60 and k=200, L=250; K2 collapse on sorted W=4 and W=13 streams
   with cross-tile runs, runs longer than a tile, counts above 255 and
   sentinels, and on a W=17 stream in the partition sort's layout, with
   sentinel runs mid-stream), with both times;
3b. K4a-d (the partition sort) against their plain versions, kernel by
   kernel and whole, bit-identical: (a) step 2's shape, 210.1M rows of
   4 key words + payload; (b) step 3's shape at K=260, 17 key words with
   ctx in the pad bits, at the row count phase 6 counted; K4c (the merge
   of K4b's sorted slots, csrc/region_merge.cu) also with its final
   gather; each kernel's time, its plain version's, its bound, and one
   stable torch.sort of the leading int64 key as the library yardstick;
   K4c's launch geometry, registers, spills and shared bytes; plus a
   skewed stream and one with real rows all ones in the comparator
   words, which must both raise the overflow flag;
3c. K3a (the key-index tile sort, csrc/bitonic_tile.cu), the cross stage
   and K3b (the bitonic sort) against their plain versions, phase by
   phase and whole, bit-identical: K3a first alone at W = 2, 4, 13, 17,
   40 on tiles of 128..8192 rows, on tie-heavy rows and on rows of which
   90% share their first word; then (a) step 2's shape, 2^28 rows of 4
   key words + payload; (b) step 3's, the power of two above phase 6's
   K2 rows, 17 key words + payload; each kernel's mean time a launch in
   one in-place sort, its launches in that sort, its plain version's
   time, its bound (a cross pass: the key words its pairs compare and the
   rows it swaps, counted on the data), one stable torch.sort of the
   leading int64 key as the library yardstick, K3a's launch geometry,
   registers, spills and shared bytes, and the in-place sort's peak
   device memory;
4. step 2 through the port's CLI entry on a 200 kb genome / 24k PE250
   pairs, --device cuda against --device cpu: small_K.freqs, HBV and
   paths must be identical;
4b. steps 1-4 (K=200, --min_freq 2) at 200 kb under W2RAP_SORT=pallas,
   --device cuda against --device cpu: the small_K, large_K and
   large_K.clean checkpoints must be identical, every K3 kernel launched,
   and Clean200x must delete edges (the kept sequencing errors branch the
   graph); its seconds printed;
5. step 2 at E. coli scale (4.6 Mbp, 550k PE250 pairs, seed 42) on the
   card with W2RAP_TIMELOG=1: both kernels launched, graph and paths
   validated, step split and peak device memory printed;
6. steps 1-4 at E. coli scale with K=260 on the card, three times:
   W2RAP_SORT=lax, radix, then pallas.  The checkpoints of the three runs
   must be identical, every K4 kernel launched in step 2 and in step 3 of
   the radix run with no exact recount, every K3 kernel in step 2 and in
   step 3 of the pallas run, HBV and paths validated; the step-3 and
   step-4 split, the K2 rows, the unique K2 kmers and the peak device
   memory printed.

Then the total seconds, one JSON line of the kernels, and last the
device JSON line.
Tolerance everywhere: exact equality (integer and bit-pattern data).
Bounds: the larger of the bytes a kernel must move (each input read once,
each output written once) over 3.35 TB/s and its integer operations (one
per compare or compare-exchange) over 67 T/s (the H100's non-tensor
32-bit rate).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from w2rap_contigger_tpu_torch import __main__ as cli  # noqa: E402
from w2rap_contigger_tpu_torch import device as tdev  # noqa: E402
from w2rap_contigger_tpu_torch.graph import validate  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitonic  # noqa: E402
from w2rap_contigger_tpu_torch.ops import collapse as kcol  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmerize as kkm  # noqa: E402
from w2rap_contigger_tpu_torch.ops import radix  # noqa: E402
from w2rap_contigger_tpu_torch.pipeline import step3_repath  # noqa: E402
from w2rap_contigger_tpu_torch.utils import sysinfo  # noqa: E402

DEV = "cuda"
SEED = 42
CHUNK_READS = 65536
READ_LEN = 250
ECOLI = {"glen": 4_600_000, "pairs": 550_000}
SMALL = {"glen": 200_000, "pairs": 24_000}
STEP2_ROWS = 1_100_000 * (READ_LEN - 60 + 1)  # E. coli k=60 kmer rows
COLLAPSE_ROWS = 16_000_000  # the W=13 and W=17 K2 checks
OVERFLOW_ROWS = 64 * 8192
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
K4 = ("radix_tile_sort", "radix_partition", "radix_region_sort", "radix_merge_pass")
K4_REPLACES = {
    "radix_tile_sort": "w2rap_contigger_tpu/ops/pallas_radix.py:152",
    "radix_partition": "w2rap_contigger_tpu/ops/pallas_radix.py:221",
    "radix_region_sort": "w2rap_contigger_tpu/ops/pallas_radix.py:108",
    "radix_merge_pass": "w2rap_contigger_tpu/ops/pallas_radix.py:162",
}
K3 = ("bitonic_tile_sort", "bitonic_cross_stage", "bitonic_merge")
K3_REPLACES = {
    "bitonic_tile_sort": "w2rap_contigger_tpu/ops/pallas_sort.py:140",
    "bitonic_cross_stage": "w2rap_contigger_tpu/ops/pallas_sort.py:183",
    "bitonic_merge": "w2rap_contigger_tpu/ops/pallas_sort.py:163",
}
CSRC = "w2rap_contigger_tpu_torch/csrc"
K4_SOURCE = f"{CSRC}/radix.cu"
K3_SOURCE = f"{CSRC}/bitonic.cu"
KERNEL_SOURCES = {"radix_region_sort": f"{CSRC}/region_merge.cu",
                  "bitonic_tile_sort": f"{CSRC}/bitonic_tile.cu"}
STEP2_POW2 = 1 << 28  # the power of two above step 2's E. coli kmer rows
SMALL_K = ("pe.small_K.hbv.npz", "pe.small_K.paths.npz")
LARGE_K = ("pe.large_K.hbv.npz", "pe.large_K.paths.npz")
CLEAN = ("pe.large_K.clean.hbv.npz", "pe.large_K.clean.paths.npz")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """(fn(), its device time in ms): one call, no warm-up (for plain
    versions, whose first call costs what every call does)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the integer rate, whichever is larger."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b) -> int:
    """Largest |difference| of the values (0 when bit-identical); u32
    bits of int32 tensors compare unsigned, int64 ones as they are."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            fail(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel() and not torch.equal(x, y):
            if x.dtype == torch.int32:
                d = (x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64) & 0xFFFFFFFF)
                err = max(err, int(d.abs().max()))
            else:
                err = max(err, int((x.double() - y.double()).abs().max()) or 1)
    return err


def fmt(fields: dict) -> dict:
    return {k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in fields.items()}


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_probe() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    say("probe", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    return card


def phase_build():
    t0 = time.time()
    _build.library()
    say("build", seconds=f"{time.time() - t0:.2f}",
        nvcc_seconds=_build.BUILD_SECONDS, sources=len(_build.sources()))


# ---------------------------------------------------------------------------
# phase 3: K1 and K2 against their plain versions
# ---------------------------------------------------------------------------


def _reads(rng, n, L):
    bases = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lengths = rng.integers(L - 40, L + 1, size=n).astype(np.int32)
    quals = rng.integers(30, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.02] = 2
    return bases, lengths, quals


def check_kmerize(k: int):
    rng = np.random.default_rng(SEED + k)
    bases, lengths, quals = _reads(rng, CHUNK_READS, READ_LEN)
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, k, 7)
    pr_d = torch.from_numpy(pr.view(np.int32)).to(DEV)
    gl_d = torch.from_numpy(glen).to(DEV)
    got = kkm.kmerize(pr_d, gl_d, k, READ_LEN)
    want = kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err or not torch.equal(got, want):
        fail(f"K1 kmerize k={k} differs from its plain version (max_abs_err {err})")
    ms = time_ms(lambda: kkm.kmerize(pr_d, gl_d, k, READ_LEN))
    plain_ms = time_ms(lambda: kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN))
    valid = int((got[0] != -1).sum())
    # the output write is the bound: W+1 planes, against the packed rows
    b, by = bound_ms(got.numel() * 4 + pr_d.numel() * 4 + gl_d.numel() * 4)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": by, "library_ms": None}
    say("kmerize", k=k, reads=CHUNK_READS, L=READ_LEN, rows=got.shape[1],
        valid_rows=valid, **fmt(res))
    return res


def sorted_stream(W: int, n: int, seed: int, regions: int = 0) -> torch.Tensor:
    """(W+1, n) int32 sorted stream: real rows in segments whose lengths
    mix typical coverage (1..60), repeats longer than a tile (5000..20000
    rows) and one run above 100k rows; payload cnt 1..3 so sums pass 255;
    then all-ones sentinel rows with payload 0.  With regions > 0 the real
    rows are cut at segment bounds into that many regions of n/regions
    rows, each followed by a run of sentinels: the partition sort's
    layout."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    dev = DEV
    n_real = int(n * (0.9 if regions else 0.95))
    seg = torch.randint(1, 61, (n_real // 30 + 1,), device=dev, generator=g)
    n_long = max(4, seg.numel() // 20000)
    pick = torch.randint(0, seg.numel(), (n_long,), device=dev, generator=g)
    seg[pick] = torch.randint(5000, 20001, (n_long,), device=dev, generator=g)
    seg[0] = 100_003  # first, so the tail cut below never drops it
    ends = torch.cumsum(seg, 0)
    seg = seg[ends <= n_real]
    n_real = int(seg.sum())
    m = seg.numel()
    # strictly increasing leading 64 bits keep the segments sorted
    lead = torch.cumsum(torch.randint(1, 1 << 20, (m,), device=dev, generator=g), 0)
    words = torch.randint(0, 1 << 32, (W, m), device=dev, generator=g, dtype=torch.int64)
    words[0] = lead >> 32
    words[1] = lead & 0xFFFFFFFF
    rows = torch.repeat_interleave(words, seg, dim=1)
    ctx = torch.randint(0, 256, (n_real,), device=dev, generator=g)
    cnt = torch.randint(1, 4, (n_real,), device=dev, generator=g)
    real = torch.empty((W + 1, n_real), dtype=torch.int32, device=dev)
    real[:W] = bk.to_raw32(rows)
    real[W] = bk.to_raw32((ctx << 8) | cnt)
    del rows
    out = torch.full((W + 1, n), -1, dtype=torch.int32, device=dev)
    out[W] = 0
    if not regions:
        out[:, :n_real] = real
        return out
    # cut at the segment end nearest above each region's share of rows
    ends = torch.cumsum(seg, 0)
    share = torch.arange(1, regions, device=dev) * n_real // regions
    cut = ends[torch.searchsorted(ends, share).clamp(max=m - 1)]
    bounds = [0] + cut.tolist() + [n_real]
    per_region = n // regions
    for r in range(regions):
        a, b = bounds[r], bounds[r + 1]
        if b - a > per_region:
            fail("sorted_stream: a region outgrew its slot")
        out[:, r * per_region : r * per_region + b - a] = real[:, a:b]
    return out


def check_collapse(W: int, n: int, min_count: int, regions: int = 0):
    planes = sorted_stream(W, n, SEED + W, regions)
    got = kcol.collapse(planes, min_count=min_count)
    want = kcol.collapse_plain(planes, min_count=min_count)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"K2 collapse W={W} differs from its plain version (max_abs_err {err})")
    del want
    ms = time_ms(lambda: kcol.collapse(planes, min_count=min_count))
    plain_ms = time_ms(lambda: kcol.collapse_plain(planes, min_count=min_count), reps=1)
    kept = int(got[1].sum())
    # the input read + the compacted output (kept rows) + the tile counts
    b, by = bound_ms(planes.numel() * 4 + kept * (W + 1) * 4 + got[1].numel() * 4)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": by, "library_ms": None}
    say("collapse", W=W, rows=n, regions=regions, min_count=min_count, kept=kept,
        low_bins=got[2][1:min_count].tolist(), **fmt(res))
    del planes, got
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3b: K4a-d against their plain versions
# ---------------------------------------------------------------------------


def kmer_stream(W: int, n: int, seed: int, payload: bool, copies: int) -> torch.Tensor:
    """A counting stream in input order: keys with `copies` rows each on
    average (pairs of keys share their first word), 8% sentinel rows;
    ctx (8 bits) in a payload plane or in the pad bits of the last word.
    (W + payload, n) int32 raw bits."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    dev = DEV
    n_uniq = max(2, n // copies)
    uniq = torch.randint(0, 1 << 32, (W, n_uniq), device=dev, generator=g, dtype=torch.int64)
    half = n_uniq // 2
    uniq[0, 1 : 2 * half : 2] = uniq[0, 0 : 2 * half : 2]
    rows = uniq[:, torch.randint(0, n_uniq, (n,), device=dev, generator=g)]
    del uniq
    ctx = torch.randint(0, 256, (n,), device=dev, generator=g)
    sent = torch.rand(n, device=dev, generator=g) < 0.08
    planes = torch.empty((W + int(payload), n), dtype=torch.int32, device=dev)
    if payload:
        planes[:W] = bk.to_raw32(rows)
        planes[W] = bk.to_raw32(torch.where(sent, 0, (ctx << 8) | 1))
    else:
        rows[W - 1] = (rows[W - 1] & (bk.FULL ^ 0xFF)) | ctx
        planes[:] = bk.to_raw32(rows)
    planes[:W, sent] = -1
    return planes


def check_radix(label: str, planes: torch.Tensor, num_keys: int, cmp_keys: int) -> dict:
    """Every K4 kernel against its plain version on the same inputs (its
    inputs from the kernel before it), the whole sort against the plain
    sort, times and bounds."""
    n = planes.shape[1]
    num_ops = planes.shape[0]
    T, n_tiles, n_bins, cap, region = radix.geometry(n)
    total = n_bins * region
    # the data's own work: sentinel rows (all ones in every key word) are
    # not taken into the slots, so neither their records nor their planes
    # need reading; rows all ones in the comparator words are the tiles'
    # tails, whose later key words K4b reads when cmp_keys < num_keys
    n_valid = n - int((planes[:num_keys] == -1).all(dim=0).sum())
    n_full = int((planes[:cmp_keys] == -1).all(dim=0).sum())
    tail_bytes = n_full * 4 * (1 + num_keys - cmp_keys) if cmp_keys < num_keys else 0
    C = min(T, region)
    widths = radix.merge_widths(region, C)
    if not widths:
        fail(f"K4 {label}: no merge level at n={n}")
    res = {}

    # K4a
    s = radix.tile_sort(planes, cmp_keys, T)
    err = max_abs_err(s, radix.tile_sort_plain(planes, cmp_keys, T))
    ms = time_ms(lambda: radix.tile_sort(planes, cmp_keys, T))
    plain_ms = time_ms(lambda: radix.tile_sort_plain(planes, cmp_keys, T), reps=1)
    lt = int(math.log2(T))
    b, by = bound_ms(n * (4 * cmp_keys + 20), n / 2 * lt * (lt + 1) / 2)
    res["radix_tile_sort"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by)

    # K4b
    sp = radix.splitters(s[0], s[1], T, n_bins)
    args = (planes, *s, *sp, num_keys, cmp_keys, T, n_bins, cap)
    part = radix.partition(*args)
    err = max_abs_err(part, radix.partition_plain(*args))
    ms = time_ms(lambda: radix.partition(*args))
    plain_ms = time_ms(lambda: radix.partition_plain(*args), reps=1)
    # the taken records read, every slot written, the tails' key words
    b, by = bound_ms(n_valid * 20 + total * 20 + tail_bytes)
    res["radix_partition"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by)
    overflow = int(part[3][0])
    recs = part[:3]
    del s, args, part

    # K4c: the chunks of K4b's sorted slots merged, as records and, as
    # the last phase of a sort with no merge level runs it, gathered
    run = min(cap, C)
    got = radix.region_sort(*recs, region, C, run)
    want = radix.region_sort_plain(*recs, region, C)
    err = max_abs_err(got, want)
    fin = radix.region_sort(*recs, region, C, run, final=(planes, num_keys))
    err = max(err, max_abs_err([fin], [radix.gather_plain(want[2], planes, num_keys)]))
    del want, fin
    torch.cuda.empty_cache()
    ms = time_ms(lambda: radix.region_sort(*recs, region, C, run))
    plain_ms = time_ms(lambda: radix.region_sort_plain(*recs, region, C), reps=1)
    lc = int(math.log2(C))
    b, by = bound_ms(total * 40, total / 2 * lc * (lc + 1) / 2)
    res["radix_region_sort"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b, bound_by=by)
    geo = radix.region_merge_geometry(C, run)
    say("radix_geometry", case=label, kernel="radix_region_sort", C=C, **geo,
        **radix.region_sort_attrs())
    del recs

    # K4d: the first level against its plain version; the time is the
    # mean of every level as the sort runs them (the last one gathering)
    one = radix.merge_pass(*got, region, widths[0])
    err = max_abs_err(one, radix.merge_pass_plain(*got, region, widths[0]))
    del one
    plain_ms = time_ms(lambda: radix.merge_pass_plain(*got, region, widths[0]), reps=1)

    def levels():
        r = got
        for i, w in enumerate(widths):
            last = i == len(widths) - 1
            r = radix.merge_pass(*r, region, w, final=(planes, num_keys) if last else None)
        return r

    ms = time_ms(levels, reps=1) / len(widths)
    L = len(widths)
    mean_log = sum(math.log2(w) for w in widths) / L
    # a level's mean: records read by every level and written by all but
    # the last, which reads the taken rows' planes and writes the output
    moved = (2 * L - 1) * total * 20 + (n_valid + total) * num_ops * 4
    b, by = bound_ms(moved / L, total * mean_log)
    res["radix_merge_pass"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b, bound_by=by)
    del got
    torch.cuda.empty_cache()

    # the whole sort, and one library sort of the leading key
    out, over = radix.partition_sort(planes, num_keys, cmp_keys)
    want, want_over = radix.partition_sort_plain(planes, num_keys, cmp_keys)
    whole_err = max_abs_err([out, over], [want, want_over])
    del out, want
    torch.cuda.empty_cache()
    whole_ms = time_ms(lambda: radix.partition_sort(planes, num_keys, cmp_keys), reps=1)
    key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
    library_ms = time_ms(lambda: torch.sort(key, stable=True), reps=1)
    del key
    torch.cuda.empty_cache()
    for name, r in res.items():
        r["library_ms"] = library_ms
        say("radix", case=label, kernel=name, rows=n, tiles=n_tiles, bins=n_bins,
            region=region, levels=len(widths), **fmt(r))
        if r["max_abs_err"]:
            fail(f"K4 {name} {label} differs from its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
    b, _ = bound_ms(n * num_keys * 4 + n_valid * (num_ops - num_keys) * 4
                    + total * num_ops * 4)
    say("radix_sort", case=label, rows=n, W=num_keys, ops=num_ops, cmp_keys=cmp_keys,
        overflow=overflow, max_abs_err=whole_err, ms=f"{whole_ms:.4f}",
        bound_ms=f"{b:.4f}", library_ms=f"{library_ms:.4f}")
    if whole_err:
        fail(f"K4 partition_sort {label} differs from its plain version ({whole_err})")
    if overflow:
        fail(f"K4 {label}: the slots overflowed on a uniform stream")
    return res


def check_radix_flags():
    """Streams that must raise the flag, each against the plain sort: a
    skewed one (one key in half the rows), and one at W=17 with real rows
    all ones in their 4 comparator words (they tie with the sentinels)."""
    skewed = kmer_stream(4, OVERFLOW_ROWS, SEED + 7, True, 16)
    skewed[:4, ::2] = 12345
    ambiguous = kmer_stream(17, OVERFLOW_ROWS, SEED + 8, False, 2)
    ambiguous[:4, 1000:1100] = -1
    ambiguous[4, 1000:1100] = 3
    for label, planes, num_keys in (("skewed", skewed, 4), ("ambiguous", ambiguous, 17)):
        out, over = radix.partition_sort(planes, num_keys, 4)
        want, want_over = radix.partition_sort_plain(planes, num_keys, 4)
        err = max_abs_err([out, over], [want, want_over])
        say("radix_overflow", case=label, rows=planes.shape[1], overflow=int(over[0]),
            max_abs_err=err)
        if err or int(over[0]) == 0:
            fail(f"K4 on the {label} stream: the overflow flag did not rise or differs")


# ---------------------------------------------------------------------------
# phase 3c: K3a, the cross stage and K3b against their plain versions
# ---------------------------------------------------------------------------


def _cross_pass_bytes(planes: torch.Tensor, num_keys: int, s: int, size: int) -> int:
    """Bytes one cross pass must move on these planes, in place: for
    every pair both rows' key words up to the first that differs, and for
    a pair that swaps both whole rows read and written."""
    num_ops, n = planes.shape
    g = n // (2 * s)
    v = planes[:num_keys].view(num_keys, g, 2, s)
    first = torch.full((g, s), num_keys - 1, dtype=torch.int32, device=planes.device)
    gt = torch.zeros((g, s), dtype=torch.bool, device=planes.device)
    for j in range(num_keys - 1, -1, -1):
        x, y = bk.from_raw32(v[j, :, 0]), bk.from_raw32(v[j, :, 1])
        d = x != y
        first = torch.where(d, j, first)
        gt = torch.where(d, x > y, gt)
        del x, y, d
    desc = ((torch.arange(g, device=planes.device) * (2 * s)) & size) != 0
    swap = gt ^ desc[:, None]
    words = torch.where(swap, 4 * num_ops, 2 * (first.to(torch.int64) + 1)).sum()
    return int(words) * 4


def _bitonic_replay(planes: torch.Tensor, num_keys: int, T: int, count_bytes: bool = False):
    """One in-place sort of a copy of planes, as bitonic_sort runs it, with
    CUDA events around every launch.  Returns ({kernel: (mean ms a launch,
    launches)}, the mean bytes a cross pass must move, or None): count
    them with count_bytes=True, which reads the planes before every cross
    pass, so its times are not the kernels'."""
    buf = planes.clone()
    marks = []
    cross_bytes = []
    for kind, x, size in bitonic.phases(planes.shape[1], T):
        if count_bytes and kind == "cross":
            cross_bytes.append(_cross_pass_bytes(buf, num_keys, x, size))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        if kind == "tile":
            bitonic.tile_sort(buf, num_keys, T)
        elif kind == "cross":
            bitonic.cross_stage(buf, num_keys, x, size)
        else:
            bitonic.merge_level(buf, num_keys, T, size)
        t1.record()
        marks.append((kind, t0, t1))
    torch.cuda.synchronize()
    del buf
    names = {"tile": "bitonic_tile_sort", "cross": "bitonic_cross_stage",
             "merge": "bitonic_merge"}
    out = {n: [0.0, 0] for n in K3}
    for kind, t0, t1 in marks:
        out[names[kind]][0] += t0.elapsed_time(t1)
        out[names[kind]][1] += 1
    mean_bytes = sum(cross_bytes) / len(cross_bytes) if count_bytes else None
    return {n: (ms / max(c, 1), c) for n, (ms, c) in out.items()}, mean_bytes


def tie_stream(W: int, n: int, seed: int, tie_first: float) -> torch.Tensor:
    """(W + 1, n) int32 planes on the card: key words from 8 values (half
    >= 2^31, so unsigned order matters), a share tie_first of rows with
    one first word, 10% sentinels; payload = row index."""
    rng = np.random.default_rng(seed)
    vals = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                     0xFFFFFFFF], dtype=np.uint32)
    keys = vals[rng.integers(0, len(vals), size=(W, n))]
    keys[0, rng.random(n) < tie_first] = 0x80000000
    keys[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    planes = np.concatenate([keys, np.arange(n, dtype=np.uint32)[None]])
    return torch.from_numpy(planes.view(np.int32)).to(DEV)


def check_bitonic_tiles():
    """K3a alone against its plain version at W = 2, 4, 13, 17, 40 on every
    tile of 128..8192 rows whose planes and indices fit one block, four
    tiles each, on tie-heavy rows and on rows 90% tied on their first
    word."""
    cases = 0
    for W in (2, 4, 13, 17, 40):
        T = 128
        while T <= 8192:
            try:
                bitonic.tile_geometry(T, W + 1)
            except ValueError:
                break
            for tie_first in (0.0, 0.9):
                planes = tie_stream(W, 4 * T, SEED + W * T, tie_first)
                got = bitonic.tile_sort(planes.clone(), W, T)
                if not torch.equal(got, bitonic.tile_sort_plain(planes, W, T)):
                    fail(f"K3a W={W} T={T} tie_first={tie_first} differs from its plain version")
                cases += 1
            T *= 2
    say("bitonic_tiles", widths="2,4,13,17,40", tiles="128..8192", cases=cases,
        identical=True)


def check_bitonic(label: str, planes: torch.Tensor, num_keys: int) -> dict:
    """Every K3 kernel against its plain version on the same inputs (its
    inputs from the kernel before it, at the first merge level; each
    kernel sorts a copy in place), the whole sort against the plain sort,
    times, bounds and the in-place sort's peak memory."""
    num_ops, n = planes.shape
    T = bitonic.tile_rows_of(num_ops, n)
    if n < 2 * T:
        fail(f"K3 {label}: n={n} is one tile, no merge level")
    plane_bytes = planes.numel() * 4
    lt = int(math.log2(T))
    res = {}

    tiled = bitonic.tile_sort(planes.clone(), num_keys, T)
    want, plain_ms = once_ms(lambda: bitonic.tile_sort_plain(planes, num_keys, T))
    err = max_abs_err([tiled], [want])
    del want
    b, by = bound_ms(2 * plane_bytes, n / 2 * lt * (lt + 1) / 2)
    res["bitonic_tile_sort"] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by)
    geo = bitonic.tile_geometry(T, num_ops)
    say("bitonic_geometry", case=label, kernel="bitonic_tile_sort", tile=T, **geo,
        **bitonic.tile_sort_attrs(geo["R"]))

    crossed = bitonic.cross_stage(tiled.clone(), num_keys, T, 2 * T)
    want, plain_ms = once_ms(lambda: bitonic.cross_stage_plain(tiled, num_keys, T, 2 * T))
    err = max_abs_err([crossed], [want])
    del want, tiled
    # the mean over the sort's passes of what a pass must move
    cross_bytes = _bitonic_replay(planes, num_keys, T, count_bytes=True)[1]
    b, by = bound_ms(cross_bytes, n / 2)
    res["bitonic_cross_stage"] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b,
                                      bound_by=by, pass_bytes=int(cross_bytes))

    merged = bitonic.merge_level(crossed.clone(), num_keys, T, 2 * T)
    want, plain_ms = once_ms(lambda: bitonic.merge_level_plain(crossed, num_keys, T, 2 * T))
    err = max_abs_err([merged], [want])
    del want
    b, by = bound_ms(2 * plane_bytes, n / 2 * lt)
    res["bitonic_merge"] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=b, bound_by=by)
    del crossed, merged
    torch.cuda.empty_cache()

    # each kernel's time and launches as one sort runs them
    _bitonic_replay(planes, num_keys, T)  # warm-up
    for name, (ms, launches) in _bitonic_replay(planes, num_keys, T)[0].items():
        res[name].update(ms=ms, launches_per_sort=launches)

    # the whole sort, in place on a copy, against the plain sort
    work = planes.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bitonic.bitonic_sort(work, num_keys)
    torch.cuda.synchronize()
    sort_peak = torch.cuda.max_memory_allocated() - base
    want, plain_whole_ms = once_ms(lambda: bitonic.bitonic_sort_plain(planes, num_keys))
    whole_err = max_abs_err([work], [want])
    del want
    torch.cuda.empty_cache()
    whole = []
    for _ in range(2):
        work.copy_(planes)
        whole.append(once_ms(lambda: bitonic.bitonic_sort(work, num_keys))[1])
    whole_ms = sum(whole) / len(whole)
    del work
    key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
    library_ms = time_ms(lambda: torch.sort(key, stable=True), reps=1)
    del key
    torch.cuda.empty_cache()
    for name, r in res.items():
        r["library_ms"] = library_ms
        say("bitonic", case=label, kernel=name, rows=n, ops=num_ops, W=num_keys, tile=T,
            **fmt(r))
        if r["max_abs_err"]:
            fail(f"K3 {name} {label} differs from its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
    ln = int(math.log2(n))
    b, by = bound_ms(2 * plane_bytes, n / 2 * ln * (ln + 1) / 2)
    say("bitonic_sort", case=label, rows=n, W=num_keys, ops=num_ops, tile=T,
        max_abs_err=whole_err, ms=f"{whole_ms:.4f}", plain_ms=f"{plain_whole_ms:.4f}",
        bound_ms=f"{b:.4f}", bound_by=by, library_ms=f"{library_ms:.4f}",
        sort_peak_bytes=sort_peak, planes_bytes=plane_bytes)
    if whole_err:
        fail(f"K3 bitonic_sort {label} differs from its plain version ({whole_err})")
    return {name: {k: v for k, v in r.items() if k not in ("launches_per_sort", "pass_bytes")}
            for name, r in res.items()}


# ---------------------------------------------------------------------------
# phases 4-6: the port's steps through its CLI entry
# ---------------------------------------------------------------------------


def synth(out_dir: str, glen: int, pairs: int):
    t0 = time.time()
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         out_dir, "--glen", str(glen), "--pairs", str(pairs),
         "--rlen", str(READ_LEN), "--insert", "500", "--seed", str(SEED)],
        check=True, capture_output=True, timeout=900,
    )
    return time.time() - t0


def run_cli(data: str, out: str, device: str, extra=(), to_step: int = 2):
    return cli.main([
        "-r", f"{data}/reads_R1.fastq,{data}/reads_R2.fastq", "-o", out,
        "--to_step", str(to_step), "--device", device, *extra,
    ])


def same_outputs(a: str, b: str, names=SMALL_K) -> list[str]:
    """small_K.freqs byte for byte and every array of the npz files."""
    diffs = []
    with open(f"{a}/small_K.freqs", "rb") as fa, open(f"{b}/small_K.freqs", "rb") as fb:
        if fa.read() != fb.read():
            diffs.append("small_K.freqs")
    for name in names:
        za, zb = np.load(f"{a}/{name}"), np.load(f"{b}/{name}")
        if sorted(za.files) != sorted(zb.files):
            diffs.append(f"{name}: keys")
            continue
        for key in za.files:
            if za[key].shape != zb[key].shape or not np.array_equal(za[key], zb[key]):
                diffs.append(f"{name}:{key}")
    return diffs


def phase_parity(work: str) -> str:
    data = f"{work}/s200"
    gen_s = synth(data, **SMALL)
    times = {}
    for dev in (DEV, "cpu"):
        t0 = time.time()
        run_cli(data, f"{data}/{dev}", dev)
        times[dev] = time.time() - t0
    diffs = same_outputs(f"{data}/{DEV}", f"{data}/cpu")
    if diffs:
        fail(f"200 kb step 2: cuda and cpu outputs differ in {diffs}")
    say("parity_200kb", genome=SMALL["glen"], pairs=SMALL["pairs"],
        synth_s=f"{gen_s:.1f}", cuda_s=f"{times[DEV]:.2f}",
        cpu_s=f"{times['cpu']:.2f}", identical=True)
    return data


def _perf_seconds(out_dir: str, name: str) -> str:
    """The seconds of one `.perf` line (`TIME, <name>, <s>, <s>`)."""
    with open(f"{out_dir}/pe.perf") as f:
        for line in f:
            fields = [x.strip() for x in line.split(",")]
            if fields[1] == name:
                return fields[2]
    fail(f"{out_dir}/pe.perf has no {name} line")


def phase_parity_step4(data: str):
    """Steps 1-4 at K=200 under W2RAP_SORT=pallas, cuda against cpu, with
    --min_freq 2: the sequencing errors it keeps give Clean200x branches
    to delete, and the edge count must fall."""
    os.environ["W2RAP_SORT"] = "pallas"
    times = {}
    try:
        for dev in (DEV, "cpu"):
            tdev.reset_launches()
            t0 = time.time()
            run_cli(data, f"{data}/{dev}4", dev,
                    ["-K", "200", "--min_freq", "2", "--dump_all", "--dump_perf"], to_step=4)
            times[dev] = time.time() - t0
            if dev == DEV:
                launches = {n: tdev.LAUNCHES[n] for n in K3}
                if min(launches.values()) <= 0:
                    fail(f"200 kb pallas run: a K3 kernel was not launched {launches}")
    finally:
        os.environ.pop("W2RAP_SORT", None)
    diffs = same_outputs(f"{data}/{DEV}4", f"{data}/cpu4", SMALL_K + LARGE_K + CLEAN)
    if diffs:
        fail(f"200 kb steps 1-4 (pallas): cuda and cpu outputs differ in {diffs}")
    edges = [len(np.load(f"{data}/{DEV}4/{name}")["inv"]) for name in (LARGE_K[0], CLEAN[0])]
    if edges[1] >= edges[0]:
        fail(f"200 kb steps 1-4: Clean200x deleted no edge ({edges[0]} -> {edges[1]})")
    say("parity_200kb_step4", K=200, sort="pallas", min_freq=2,
        cuda_s=f"{times[DEV]:.2f}", cpu_s=f"{times['cpu']:.2f}",
        edges_large_K=edges[0], edges_clean=edges[1],
        clean200x_cuda_s=_perf_seconds(f"{data}/{DEV}4", "Clean200x"),
        clean200x_cpu_s=_perf_seconds(f"{data}/cpu4", "Clean200x"),
        k3_launches=json.dumps(launches), identical=True)


def _split() -> dict:
    split = {}
    for line in sysinfo.timelog_report().splitlines():
        _, name, secs, _ = [x.strip() for x in line.split(",")]
        split[name] = secs
    return split


def phase_scale(data: str) -> dict:
    os.environ["W2RAP_TIMELOG"] = "1"
    sysinfo.timelog_reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tdev.reset_launches()
    t0 = time.time()
    hbv, paths, d = run_cli(data, f"{data}/out", DEV, ["--dump_perf"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(tdev.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("kmerize", "collapse"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    with open(f"{data}/out/pe.perf") as f:
        perf = " | ".join(x.strip() for x in f)
    say("ecoli_step2", genome=ECOLI["glen"], pairs=ECOLI["pairs"], reads=paths.n_reads,
        wall_s=f"{wall:.2f}", unique_kmers=d.size,
        edges=hbv.n_edges, path_edges=len(paths.edges),
        max_memory_allocated=peak, launches=json.dumps(launches))
    say("ecoli_split", **_split())
    say("ecoli_perf", perf=repr(perf))
    return launches


def phase_step4(data: str) -> tuple[dict, int]:
    """Steps 1-4 at K=260 under lax, radix, then pallas; returns each
    run's launches and the step-3 stream's row count."""
    os.environ["W2RAP_TIMELOG"] = "1"
    rows = {}
    step3 = {}
    orig_count = tke.count_kmers_flat
    orig_repath = step3_repath.repath

    def count_flat(flat, seg, k, *a, **kw):
        rows["k2"] = max(len(flat) - k + 1, 0)
        return orig_count(flat, seg, k, *a, **kw)

    def repath(*a, **kw):
        before = dict(tdev.LAUNCHES)
        out = orig_repath(*a, **kw)
        step3.update({n: tdev.LAUNCHES[n] - before[n] for n in before})
        return out

    tke.count_kmers_flat = count_flat
    step3_repath.repath = repath
    runs = {}
    try:
        for sort in ("lax", "radix", "pallas"):
            os.environ["W2RAP_SORT"] = sort
            sysinfo.timelog_reset()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            tdev.reset_launches()
            recounts = tke.RADIX_RECOUNTS
            t0 = time.time()
            hbv, paths, d = run_cli(data, f"{data}/k260_{sort}", DEV,
                                    ["-K", "260", "--dump_all", "--dump_perf"], to_step=4)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = runs[sort] = dict(tdev.LAUNCHES)
            validate.test_involution(hbv)
            validate.validate_paths(hbv, paths)
            with open(f"{data}/k260_{sort}/pe.perf") as f:
                perf = " | ".join(x.strip() for x in f)
            say("ecoli_k260", sort=sort, wall_s=f"{wall:.2f}", k2_rows=rows["k2"],
                k2_unique_kmers=d.size, edges=hbv.n_edges, path_edges=len(paths.edges),
                recounts=tke.RADIX_RECOUNTS - recounts,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=json.dumps(launches), step3_launches=json.dumps(step3))
            say("ecoli_k260_split", sort=sort, **{
                k: v for k, v in _split().items()
                if k.startswith(("step2.count", "step3", "step4"))})
            say("ecoli_k260_perf", sort=sort, perf=repr(perf))
            sort_kernels = {"radix": K4, "pallas": K3}.get(sort, ())
            if sort == "radix" and tke.RADIX_RECOUNTS != recounts:
                fail("the radix run fell back to the exact lax recount")
            for name in sort_kernels:
                if step3[name] <= 0 or launches[name] - step3[name] <= 0:
                    fail(f"kernel {name} was not launched in step 2 and step 3")
    finally:
        tke.count_kmers_flat = orig_count
        step3_repath.repath = orig_repath
        os.environ.pop("W2RAP_SORT", None)
    for sort in ("radix", "pallas"):
        diffs = same_outputs(f"{data}/k260_lax", f"{data}/k260_{sort}",
                             SMALL_K + LARGE_K + CLEAN)
        if diffs:
            fail(f"E. coli K=260: lax and {sort} checkpoints differ in {diffs}")
    say("ecoli_k260_identical", lax_vs_radix=True, lax_vs_pallas=True)
    return runs, rows["k2"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", default=None,
                    help="keep the synthetic data and outputs in this directory")
    args = ap.parse_args()
    t_start = time.time()
    card = phase_probe()
    phase_build()
    t0 = time.time()
    k1 = check_kmerize(60)
    check_kmerize(200)
    k2 = check_collapse(4, STEP2_ROWS, min_count=4)
    check_collapse(13, COLLAPSE_ROWS, min_count=1)
    check_collapse(17, COLLAPSE_ROWS, min_count=1, regions=16)
    say("phase3", seconds=f"{time.time() - t0:.1f}")

    # 3b (a): step 2's shape, 4 key words + payload (the radix stream
    # keeps ctx out of the comparator words)
    t0 = time.time()
    T = radix.DEFAULT_TILE_ROWS * radix.LANES
    planes = kmer_stream(4, -(-STEP2_ROWS // T) * T, SEED, True, 45)
    k4 = check_radix("step2_W4", planes, 4, 4)
    del planes
    torch.cuda.empty_cache()
    check_radix_flags()
    say("phase3b_a", seconds=f"{time.time() - t0:.1f}")

    # 3c (a): K3a alone on small tiles, then step 2's shape under
    # pallas, 4 key words + payload
    t0 = time.time()
    check_bitonic_tiles()
    planes = kmer_stream(4, STEP2_POW2, SEED + 3, True, 45)
    k3 = check_bitonic("step2_W4", planes, 4)
    del planes
    torch.cuda.empty_cache()
    say("phase3c_a", seconds=f"{time.time() - t0:.1f}")

    with tempfile.TemporaryDirectory(prefix="w2rap_smoke_") as tmp:
        work = args.work or tmp
        os.makedirs(work, exist_ok=True)
        t0 = time.time()
        s200 = phase_parity(work)
        say("phase4", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        phase_parity_step4(s200)
        say("phase4b", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        data = f"{work}/ecoli"
        say("synth_ecoli", seconds=f"{synth(data, **ECOLI):.1f}")
        launches = phase_scale(data)
        say("phase5", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        runs, k2_rows = phase_step4(data)
        say("phase6", seconds=f"{time.time() - t0:.1f}")

    # 3b (b): step 3's shape at K=260, 17 key words with ctx in the pad bits
    t0 = time.time()
    planes = kmer_stream(17, -(-k2_rows // T) * T, SEED + 17, False, 2)
    check_radix("step3_W17", planes, 17, 4)
    del planes
    torch.cuda.empty_cache()
    say("phase3b_b", seconds=f"{time.time() - t0:.1f}")

    # 3c (b): step 3's shape under pallas, 17 key words + payload, the
    # power of two the stream of phase 6's K2 rows pads to
    t0 = time.time()
    planes = kmer_stream(17, max(1 << k2_rows.bit_length(), 128), SEED + 18, True, 2)
    check_bitonic("step3_W17", planes, 17)
    del planes
    torch.cuda.empty_cache()
    say("phase3c_b", seconds=f"{time.time() - t0:.1f}")

    kernels = [
        {"name": "kmerize", "route": "cuda",
         "source": "w2rap_contigger_tpu_torch/csrc/kmerize.cu",
         "replaces": "w2rap_contigger_tpu/ops/pallas_kmer.py:64",
         "launches": launches["kmerize"], **k1},
        {"name": "collapse", "route": "cuda",
         "source": "w2rap_contigger_tpu_torch/csrc/collapse.cu",
         "replaces": "w2rap_contigger_tpu/ops/pallas_collapse.py:83",
         "launches": launches["collapse"], **k2},
    ] + [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES.get(name, K4_SOURCE),
         "replaces": K4_REPLACES[name], "launches": runs["radix"][name], **k4[name]}
        for name in K4
    ] + [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES.get(name, K3_SOURCE),
         "replaces": K3_REPLACES[name], "launches": runs["pallas"][name], **k3[name]}
        for name in K3
    ]
    say("total", seconds=f"{time.time() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
