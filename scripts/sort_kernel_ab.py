"""K3a, K3b and K4a (the kernels on csrc/keyindex_net.cuh), K4d (the
radix merge level) and K2 (collapse) checked and timed in one process on
one GPU, optionally beside another checkout's.

    python3 scripts/sort_kernel_ab.py [--parent DIR ...] [--rounds 2]
        [--kernels k4a k4b k3 k4d k2]

Prints each kernel's registers, spilled (local) bytes and static shared
memory at R = 2, 4, 8, 16 rows a thread (cudaFuncGetAttributes); holds
every R of each kernel bit for bit against its plain version on small
tie-heavy streams (K3a and K3b at W = 1, 2, 4, 13, 17, 40 and tiles of
128..16384 rows, K3b at levels 2T and 4T; K4a at cmp_keys 1-4 on odd
tile counts of 128..8192 rows, with rows all ones in the comparator
words; each also with 90% of rows tied on their first word); then, at
step 2's and step 3's shapes (`chip_smoke.py`'s streams: K4a on 210.1M
rows of 4 key words + payload and on 4,599,661 K2 rows of 17 key words;
K3a and K3b on 2^28 rows of 4 key words + payload and 2^23 rows of 17 +
payload, K3b at the first and at the last merge level as the sort feeds
them: the last one's tiles hold runs of copies of one kmer, tied on
every key word), checks every
R the tile allows and times them in turns (a, b, ..., b, a), each a mean
of CUDA-event times over --rounds turns, beside one stable torch.sort of
the leading int64 key.  With --parent DIR ..., unpacked checkouts of
other commits of the port (in a directory .gitignore lists), each
commit's K3a, K3b and K4a are built from its DIR, checked against the
same plain versions and timed in the same turns under the DIR's name.
Exits non-zero on any mismatch.

K4d and K2 (--kernels k4d k2): their registers, spills and static
shared memory, then each variant held bit for bit against the plain
version and timed in turns beside the DIRs' kernels: K4d at its first
level (records) and its last (gathering the planes) of step 2's and step
3's sorts, as `chip_smoke.py` feeds them, with P = 8 (the port's) and P
= 16 records a thread; K2 on `chip_smoke.py`'s sorted streams (W=4 at
210.1M rows, min_count 4; W=13 and W=17 at 16M rows, W=17 in 16
regions; W=4 at 16M rows with a 100k-row run of one ctx) at tiles of
4096 and 2048 rows, and with V = 8 rows a thread (512 threads).  A
variant is this checkout's csrc/ with one constant changed, built from a
copy under csrc/build/variants/.

K4b (--kernels k4b): registers and spills, then this checkout's kernel
and the DIRs' against the plain version on 72 small cases (tiles of
128, 2048 and 8192 rows; cmp_keys 1-4 below and at num_keys; 8%
sentinel rows mid-stream, the port's own stream layout with a few
padding rows a tile, ambiguous rows, a skewed stream whose slots
overflow), then all of them timed in turns at step 2's shape and at
step 3's, on the synthetic stream and on the port's own layout of it
(20 launches between two events at step 3's shape, 3 at step 2's).

The port runs each kernel at the R that `bitonic.tile_geometry` takes
from the tile; the other R are the kernels' own template instances,
launched here through their C entry points.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build, bitonic, radix  # noqa: E402
from w2rap_contigger_tpu_torch.ops import collapse as kcol  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke  # noqa: E402

STEP3_K2_ROWS = 4_599_661  # E. coli K=260 K2 rows (chip_smoke.py phase 6)
RS = (2, 4, 8, 16)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def load_parent(root: str):
    """The kernel library of another checkout of the port, built by that
    checkout's own ops/_build.py from its csrc/."""
    path = os.path.join(root, "w2rap_contigger_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(f"build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


# variant name -> (source, pattern, replacement): this checkout's csrc/
# with one constant changed
VARIANTS = {
    "k4d_P16": ("radix.cu", r"constexpr int MERGE_P = 8;", "constexpr int MERGE_P = 16;"),
    "k2_V8": ("collapse.cu",
              r"constexpr int COLLAPSE_THREADS = 256;((?:\n//[^\n]*)*)\nconstexpr int V = 16;",
              r"constexpr int COLLAPSE_THREADS = 512;\1\nconstexpr int V = 8;"),
}


def build_variant(name: str, spec=None):
    """The kernel library of this checkout with VARIANTS[name] (or spec:
    source, pattern, replacement) applied, built in a copy under
    csrc/build/variants/<name>."""
    src, pat, rep = spec or VARIANTS[name]
    root = os.path.join(_build.BUILD_DIR, "variants", name)
    pkg = os.path.join(root, "w2rap_contigger_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(pkg, "ops"))
    shutil.copy(os.path.join(REPO, "w2rap_contigger_tpu_torch", "ops", "_build.py"),
                os.path.join(pkg, "ops"))
    shutil.copytree(os.path.dirname(_build.sources()[0]), os.path.join(pkg, "csrc"),
                    ignore=shutil.ignore_patterns("build"))
    path = os.path.join(pkg, "csrc", src)
    with open(path) as f:
        text, hits = re.subn(pat, rep, f.read())
    if hits != 1:
        cs.fail(f"variant {name}: {pat!r} found {hits} times in {src}")
    with open(path, "w") as f:
        f.write(text)
    return load_parent(root)


def _geometry(fn, n_plain: int, R: int, T: int, nplanes: int) -> tuple:
    """(R, threads, bytes) where the entry point takes the network's
    geometry, () for an older one with n_plain arguments, which does not."""
    if len(fn.argtypes) == n_plain:
        return ()
    return (R, T // R, nplanes * T * 4 + 4 * T)


def k3a(lib, planes: torch.Tensor, W: int, T: int, R: int) -> torch.Tensor:
    """K3a in place at R rows a thread through lib's C entry point."""
    num_ops, n = planes.shape
    err = lib.w2rap_bitonic_tile_sort(planes.data_ptr(), n, num_ops, W, T, R, T // R,
                                      num_ops * T * 4 + 4 * T, _stream())
    _build.check(err, f"K3a R={R}")
    return planes


def k3b(lib, planes: torch.Tensor, W: int, T: int, size: int, R: int) -> torch.Tensor:
    """K3b (merge level `size`) in place at R rows a thread (an older
    library's K3b takes no geometry)."""
    num_ops, n = planes.shape
    fn = lib.w2rap_bitonic_merge
    err = fn(planes.data_ptr(), n, num_ops, W, T, size,
             *_geometry(fn, 7, R, T, num_ops), _stream())
    _build.check(err, f"K3b R={R}")
    return planes


def k4a(lib, planes: torch.Tensor, cmp_keys: int, T: int, R: int):
    """K4a's records at R rows a thread (an older library's K4a takes no
    geometry)."""
    n = planes.shape[1]
    out = (torch.empty(n, dtype=torch.int64, device=planes.device),
           torch.empty(n, dtype=torch.int64, device=planes.device),
           torch.empty(n, dtype=torch.int32, device=planes.device))
    fn = lib.w2rap_radix_tile_sort
    err = fn(planes.data_ptr(), n, cmp_keys, T, *_geometry(fn, 8, R, T, cmp_keys),
             *(o.data_ptr() for o in out), _stream())
    _build.check(err, f"K4a R={R}")
    return out


def variants(T: int, nplanes: int) -> list[int]:
    """The R a T-row tile of nplanes planes can run at."""
    fits = nplanes * T * 4 + 4 * T <= bitonic.SMEM_MAX_BYTES
    return [R for R in RS if fits and 32 <= T // R <= bitonic.TILE_THREADS]


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_small(lib) -> None:
    cases = 0
    for W in (1, 2, 4, 13, 17, 40):
        T = 128
        while T <= 16384:
            for R in variants(T, W + 1):
                for tie_first in (0.0, 0.9):
                    planes = cs.tie_stream(W, 4 * T, W * T + R, tie_first)
                    if not same(k3a(lib, planes.clone(), W, T, R),
                                bitonic.tile_sort_plain(planes, W, T)):
                        cs.fail(f"K3a W={W} T={T} R={R} tie_first={tie_first} differs")
                    for size in (2 * T, 4 * T):
                        if not same(k3b(lib, planes.clone(), W, T, size, R),
                                    bitonic.merge_level_plain(planes, W, T, size)):
                            cs.fail(f"K3b W={W} T={T} R={R} size={size} "
                                    f"tie_first={tie_first} differs")
                    cases += 1
            T *= 2
    for cmp_keys in (1, 2, 3, 4):
        for T, tiles in ((128, 5), (1024, 3), (2048, 3), (4096, 3), (8192, 3)):
            for R in variants(T, cmp_keys):
                for tie_first in (0.0, 0.9):
                    planes = cs.tie_stream(5, T * tiles, 7 * T + cmp_keys, tie_first)
                    planes[:cmp_keys, 3::19] = -1  # all ones in the comparator words only
                    if not same(k4a(lib, planes, cmp_keys, T, R),
                                radix.tile_sort_plain(planes, cmp_keys, T)):
                        cs.fail(f"K4a cmp_keys={cmp_keys} T={T} R={R} "
                                f"tie_first={tie_first} differs")
                    cases += 1
    cs.say("small", kernels="K3a,K3b,K4a", cases=cases, identical=True)


def event_ms(kernel, setup=None):
    """A function that runs setup(), then kernel() between CUDA events,
    and returns the kernel's ms."""
    def run():
        if setup is not None:
            setup()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        kernel()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)
    return run


def turns(fns: dict, rounds: int) -> dict:
    """Mean ms of each fn over rounds turns of (a, b, ..., b, a), after one
    warm-up call each."""
    names = list(fns)
    for fn in fns.values():
        fn()
    acc = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            acc[k].append(fns[k]())
    return {k: sum(v) / len(v) for k, v in acc.items()}


def label_of(name: str, R: int) -> str:
    """A variant's name: this checkout's kernel at R, or another
    checkout's at the R its own wrapper takes."""
    return f"new_R{R}" if name == "new" else name


def time_k4a(label: str, planes, cmp_keys: int, key, libs: dict, rounds: int) -> None:
    T = radix.DEFAULT_TILE_ROWS * radix.LANES
    R0 = bitonic.tile_geometry(T, cmp_keys)["R"]
    want = radix.tile_sort_plain(planes, cmp_keys, T)
    fns = {}
    for name, lib in libs.items():
        for R in variants(T, cmp_keys) if name == "new" else [R0]:
            if not same(k4a(lib, planes, cmp_keys, T, R), want):
                cs.fail(f"K4a {label} {name} R={R} differs from its plain version")
            fns[label_of(name, R)] = event_ms(
                lambda lib=lib, R=R: k4a(lib, planes, cmp_keys, T, R))
    del want
    torch.cuda.empty_cache()
    fns["torch_sort"] = event_ms(lambda: torch.sort(key, stable=True))
    for k, ms in turns(fns, rounds).items():
        cs.say("k4a_time", case=label, tile=T, variant=k, ms=f"{ms:.4f}")


def merge_input(planes, W: int, T: int, size: int) -> torch.Tensor:
    """A copy of planes sorted by the network up to the merge of level
    size: what K3b at that level takes."""
    out = planes.clone()
    for kind, x, sz in bitonic.phases(planes.shape[1], T):
        if kind == "merge" and sz == size:
            return out
        if kind == "tile":
            bitonic.tile_sort(out, W, T)
        elif kind == "cross":
            bitonic.cross_stage(out, W, x, sz)
        else:
            bitonic.merge_level(out, W, T, sz)
    raise ValueError(f"no merge level {size}")


def time_k3(label: str, planes, W: int, key, libs: dict, rounds: int) -> None:
    """K3a on the stream and K3b on its first and its last merge level's
    input, every variant checked."""
    n = planes.shape[1]
    T = bitonic.tile_rows_of(planes.shape[0], n)
    R0 = bitonic.tile_geometry(T, planes.shape[0])["R"]
    rs = variants(T, planes.shape[0])
    first = merge_input(planes, W, T, 2 * T)
    last = merge_input(planes, W, T, n)
    buf = torch.empty_like(planes)
    fns = {}
    for kernel, src, plain, call in (
            ("k3a", planes, lambda: bitonic.tile_sort_plain(planes, W, T),
             lambda lib, R: k3a(lib, buf, W, T, R)),
            ("k3b_first", first, lambda: bitonic.merge_level_plain(first, W, T, 2 * T),
             lambda lib, R: k3b(lib, buf, W, T, 2 * T, R)),
            ("k3b_last", last, lambda: bitonic.merge_level_plain(last, W, T, n),
             lambda lib, R: k3b(lib, buf, W, T, n, R))):
        want = plain()
        for name, lib in libs.items():
            for R in rs if name == "new" else [R0]:
                buf.copy_(src)
                if not same(call(lib, R), want):
                    cs.fail(f"{kernel} {label} {name} R={R} differs from its plain version")
                fns[f"{kernel}_{label_of(name, R)}"] = event_ms(
                    lambda lib=lib, R=R, call=call: call(lib, R),
                    setup=lambda src=src: buf.copy_(src))
        del want
        torch.cuda.empty_cache()
    fns["torch_sort"] = event_ms(lambda: torch.sort(key, stable=True))
    for k, ms in turns(fns, rounds).items():
        cs.say("k3_time", case=label, tile=T, variant=k, ms=f"{ms:.4f}")


def k4d(lib, recs, region: int, width: int, final=None):
    """One K4d level through lib's C entry point: records, or (final =
    (planes, num_keys)) the gathered planes."""
    total = recs[0].shape[0]
    if final:
        planes, num_keys = final
        out = torch.empty((planes.shape[0], total), dtype=torch.int32, device=planes.device)
        dst, gather = (None, None, None), (planes.data_ptr(), planes.shape[1],
                                           planes.shape[0], num_keys, out.data_ptr())
    else:
        out = tuple(torch.empty_like(r) for r in recs)
        dst, gather = tuple(r.data_ptr() for r in out), (None, 0, 0, 0, None)
    err = lib.w2rap_radix_merge_pass(*(r.data_ptr() for r in recs), *dst, total, region,
                                     width, int(bool(final)), *gather, _stream())
    _build.check(err, "K4d")
    return out


def time_k4d(label: str, planes, num_keys: int, libs: dict, rounds: int) -> None:
    """K4d's first and last level of one sort of planes, every library
    checked against the plain version, then timed in turns."""
    n = planes.shape[1]
    T, n_tiles, n_bins, cap, region = radix.geometry(n)
    s = radix.tile_sort(planes, 4, T)
    sp = radix.splitters(s[0], s[1], T, n_bins)
    *recs, _ = radix.partition(planes, *s, *sp, num_keys, 4, T, n_bins, cap)
    del s
    C = min(T, region)
    widths = radix.merge_widths(region, C)
    first = radix.region_sort(*recs, region, C, min(cap, C))
    del recs
    last = first
    for w in widths[:-1]:
        last = radix.merge_pass(*last, region, w)
    final = (planes, num_keys)
    fns = {}
    for level, src, w, fin in (("first", first, widths[0], None),
                               ("last", last, widths[-1], final)):
        want = radix.merge_pass_plain(*src, region, w)
        if fin:
            want = radix.gather_plain(want[2], planes, num_keys)
        for name, lib in libs.items():
            if not same(k4d(lib, src, region, w, fin), want):
                cs.fail(f"K4d {label} {level} level {name} differs from its plain version")
            fns[f"k4d_{level}_{name}"] = event_ms(
                lambda lib=lib, src=src, w=w, fin=fin: k4d(lib, src, region, w, fin))
        del want
        torch.cuda.empty_cache()
    for k, ms in turns(fns, rounds).items():
        cs.say("k4d_time", case=label, levels=len(widths), variant=k, ms=f"{ms:.4f}")


def k2(lib, planes, min_count: int, tile: int):
    """K2 through lib's C entry point."""
    W, n = planes.shape[0] - 1, planes.shape[1]
    out = torch.empty_like(planes)
    counts = torch.empty(-(-n // tile), dtype=torch.int32, device=planes.device)
    low = torch.zeros(kcol.LOW_BINS, dtype=torch.int32, device=planes.device)
    err = lib.w2rap_collapse(planes.data_ptr(), n, W, min_count, tile, out.data_ptr(),
                             counts.data_ptr(), low.data_ptr(), _stream())
    _build.check(err, "K2")
    return out, counts, low


def time_k2(libs: dict, rounds: int) -> None:
    """K2 on chip_smoke.py's sorted streams: every library at the
    port's tile (and this checkout's also at 2048 rows) checked against
    the plain version, then timed in turns."""
    for label, W, n, mc, regions, one_ctx in (
            ("step2_W4", 4, cs.STEP2_ROWS, 4, 0, False),
            ("W13", 13, cs.COLLAPSE_ROWS, 1, 0, False),
            ("W17_regions", 17, cs.COLLAPSE_ROWS, 1, 16, False),
            ("W4_one_ctx", 4, cs.COLLAPSE_ROWS, 4, 0, True)):
        planes = cs.sorted_stream(W, n, cs.SEED + W, regions, one_ctx)
        fns = {}
        for tile in (kcol.TILE, 2048):
            want = kcol.collapse_plain(planes, mc, tile)
            for name, lib in libs.items():
                if tile != kcol.TILE and name != "new":
                    continue
                if not same(k2(lib, planes, mc, tile), want):
                    cs.fail(f"K2 {label} tile {tile} {name} differs from its plain version")
                fns[f"k2_tile{tile}_{name}"] = event_ms(
                    lambda lib=lib, tile=tile: k2(lib, planes, mc, tile))
            del want
            torch.cuda.empty_cache()
        for k, ms in turns(fns, rounds).items():
            cs.say("k2_time", case=label, W=W, rows=n, variant=k, ms=f"{ms:.4f}")
        del planes
        torch.cuda.empty_cache()


def check_small_k4d_k2(libs: dict) -> None:
    """K4d at every level of small sorts (128-row tiles in one bin: 32 to
    256 threads a block; 2048-row tiles in 4 bins: short and partnerless
    last runs), as records and gathering, on a uniform and on a skewed
    stream; K2 at tiles of 256, 1024 and 4096 rows on small sorted
    streams (plain, in regions, with a one-ctx 100k-row run) at W = 4,
    13, 17, n a multiple of 4 and not; every library against the plain
    versions."""
    cases = 0
    for n, W, tile_rows, n_bins in ((80 * 128, 4, 1, None), (12 * 2048, 5, 16, 4)):
        for copies in (2, 400):
            planes = cs.kmer_stream(W, n, cs.SEED + n + copies, True, copies)
            T, n_tiles, nb, cap, region = radix.geometry(n, tile_rows, n_bins)
            s = radix.tile_sort(planes, 4, T)
            sp = radix.splitters(s[0], s[1], T, nb)
            *recs, _ = radix.partition(planes, *s, *sp, W, 4, T, nb, cap)
            C = min(T, region)
            recs = radix.region_sort_plain(*recs, region, C)
            for w in radix.merge_widths(region, C):
                want = radix.merge_pass_plain(*recs, region, w)
                gathered = radix.gather_plain(want[2], planes, W)
                for name, lib in libs.items():
                    if w < 16 * 16 and "P16" in name:
                        continue
                    if not (same(k4d(lib, recs, region, w), want)
                            and same(k4d(lib, recs, region, w, (planes, W)), gathered)):
                        cs.fail(f"K4d small n={n} width={w} {name} differs")
                    cases += 1
                recs = want
    for W, tile, mc, regions, one_ctx in ((4, 256, 4, 0, False), (13, 1024, 1, 2, False),
                                          (17, 4096, 1, 0, True), (4, 4096, 4, 2, True)):
        for n in (400_000, 400_003):
            planes = cs.sorted_stream(W, n, cs.SEED + tile + n, regions, one_ctx)
            want = kcol.collapse_plain(planes, mc, tile)
            for name, lib in libs.items():
                if not same(k2(lib, planes, mc, tile), want):
                    cs.fail(f"K2 small W={W} tile={tile} n={n} {name} differs")
                cases += 1
    cs.say("small", kernels="K4d,K2", libraries=",".join(libs), cases=cases, identical=True)


def own_layout(planes, W: int, T: int) -> torch.Tensor:
    """planes as the port's counting stream lays them out under radix
    (kmer_engine.Stream): rows all ones in the W key words (invalid
    windows) dropped, a few padding rows at the end of each T-row tile."""
    return tke.spread_padding(planes[:, ~(planes[:W] == -1).all(dim=0)], W, T)


def k4b_args(planes, num_keys: int, cmp_keys: int, tile_rows=None, n_bins=None):
    """K4b's arguments for planes: the sorted tiles (K4a) and splitters."""
    T, n_tiles, nb, cap, region = radix.geometry(planes.shape[1], tile_rows, n_bins)
    s = radix.tile_sort(planes, cmp_keys, T)
    sp = radix.splitters(s[0], s[1], T, nb)
    return (planes, *s, *sp, num_keys, cmp_keys, T, nb, cap)


def partition_with(entry, planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys: int,
                   cmp_keys: int, T: int, n_bins: int, cap: int):
    """radix.partition through another build's C entry point (not counted
    as a launch of the port)."""
    n = planes.shape[1]
    region = (n // T) * cap
    r_hi, r_lo, r_idx = (torch.empty(n_bins * region, dtype=d, device=planes.device)
                         for d in (torch.int64, torch.int64, torch.int32))
    overflow = torch.zeros(1, dtype=torch.int32, device=planes.device)
    err = entry(
        planes.data_ptr(), n, num_keys, cmp_keys, T, n_bins, cap,
        sp_hi.data_ptr(), sp_lo.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(),
        s_idx.data_ptr(), r_hi.data_ptr(), r_lo.data_ptr(), r_idx.data_ptr(),
        region, overflow.data_ptr(), _stream())
    _build.check(err, "w2rap_radix_partition")
    return r_hi, r_lo, r_idx, overflow


def check_small_k4b(libs: dict) -> None:
    """K4b of each library against the plain version on small
    streams: tiles of 128, 2048 and 8192 rows (1, 4 and 16 bins), odd
    tile counts, cmp_keys 1-4 below and at num_keys; 8% sentinel rows
    mid-stream, the port's own layout (a few padding rows a tile), real
    rows all ones in their comparator words (ambiguous), and a skewed
    stream whose slots overflow (at 4 and 16 bins)."""
    cases = 0
    for T, tiles in ((128, 5), (2048, 3), (8192, 3)):
        n = T * tiles
        for W, cmp_keys, payload in ((4, 4, True), (5, 4, True), (17, 4, False),
                                     (13, 2, True), (2, 1, True), (3, 3, False)):
            base = cs.kmer_stream(W, n, cs.SEED + T + W, payload, 3)
            streams = {"sentinels": base}
            streams["own"] = own_layout(base, W, T)
            amb = base.clone()
            amb[:cmp_keys, 7 :: 97] = -1
            streams["ambiguous"] = amb
            skew = base.clone()
            skew[:W, ::2] = 12345
            streams["skewed"] = skew
            for label, planes in streams.items():
                args = k4b_args(planes, W, cmp_keys, T // radix.LANES)
                want = radix.partition_plain(*args)
                for name, lib in libs.items():
                    got = partition_with(lib.w2rap_radix_partition, *args)
                    if not same(got, want):
                        cs.fail(f"K4b {name} T={T} W={W} cmp_keys={cmp_keys} "
                                f"{label} differs from its plain version")
                if label == "skewed" and T >= 2048 and int(want[3][0]) == 0:
                    cs.fail(f"K4b T={T} W={W}: the skewed stream did not overflow")
                cases += 1
    cs.say("small", kernels="K4b", libraries=",".join(libs), cases=cases, identical=True)


def repeat(fn, reps: int) -> None:
    for _ in range(reps):
        fn()


def time_k4b(label: str, planes, num_keys: int, libs: dict, rounds: int,
             reps: int) -> None:
    """K4b of each library on one stream, checked against the plain
    version and timed in turns, `reps` launches between two events."""
    args = k4b_args(planes, num_keys, 4)
    want = radix.partition_plain(*args)
    fns = {}
    for name, lib in libs.items():
        fn = lambda lib=lib: partition_with(lib.w2rap_radix_partition, *args)  # noqa: E731
        if not same(fn(), want):
            cs.fail(f"K4b {label} {name} differs from its plain version")
        fns[name] = event_ms(lambda fn=fn: repeat(fn, reps))
    del want
    torch.cuda.empty_cache()
    for k, ms in turns(fns, rounds).items():
        cs.say("k4b_time", case=label, rows=planes.shape[1], variant=k,
               ms=f"{ms / reps:.4f}")


def attrs_of(lib, entry: str) -> dict:
    """Registers, spilled bytes and static shared memory of a kernel of
    lib (this checkout's or a variant's) through its `*_attrs` entry."""
    buf = (ctypes.c_int * 4)()
    _build.check(getattr(lib, entry)(buf), entry)
    return {"regs": buf[0], "local_bytes": buf[1], "static_smem": buf[2]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="*", default=[],
                    help="unpacked checkouts of other commits of the port")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", nargs="+", default=["k4a", "k3", "k4d", "k2"],
                    choices=["k4a", "k4b", "k3", "k4d", "k2"])
    ap.add_argument("--small", action="store_true",
                    help="K4d and K2: attributes and the small checks only")
    args = ap.parse_args()
    card = cs.phase_probe()
    cs.phase_build()
    lib = _build.library()
    libs = {"new": lib, **{os.path.basename(os.path.normpath(d)): load_parent(d)
                           for d in args.parent}}
    if "k4b" in args.kernels:
        for name, vlib in libs.items():
            if hasattr(vlib, "w2rap_radix_partition_attrs"):
                cs.say("attrs", kernel="radix_partition", variant=name,
                       **attrs_of(vlib, "w2rap_radix_partition_attrs"))
        check_small_k4b(libs)
        T = radix.DEFAULT_TILE_ROWS * radix.LANES
        for label, W, rows, payload, copies in (
                ("step2_W4", 4, cs.STEP2_ROWS, True, 45),
                ("step3_W17", 17, STEP3_K2_ROWS, False, 2),
                ("step3_W17_own", 17, STEP3_K2_ROWS, False, 2)):
            planes = cs.kmer_stream(W, -(-rows // T) * T, cs.SEED + W, payload, copies)
            if label.endswith("_own"):
                planes = own_layout(planes, W, T)
            time_k4b(label, planes, W, libs, args.rounds, 3 if W == 4 else 20)
            del planes
            torch.cuda.empty_cache()
    if "k4d" in args.kernels or "k2" in args.kernels:
        variants = {v: build_variant(v) for v in VARIANTS
                    if v.split("_")[0] in args.kernels}
        for name, vlib in {"new": lib, **variants}.items():
            for kernel, entry in (("radix_merge_pass", "w2rap_radix_merge_pass_attrs"),
                                  ("collapse", "w2rap_collapse_attrs")):
                cs.say("attrs", kernel=kernel, variant=name, **attrs_of(vlib, entry))
        check_small_k4d_k2({**libs, **variants})
        if args.small:
            print(card, flush=True)
            return
        if "k4d" in args.kernels:
            k4d_libs = {**libs, **{v: x for v, x in variants.items() if v.startswith("k4d")}}
            T = radix.DEFAULT_TILE_ROWS * radix.LANES
            for label, W, rows, payload, copies in (
                    ("step2_W4", 4, cs.STEP2_ROWS, True, 45),
                    ("step3_W17", 17, STEP3_K2_ROWS, False, 2)):
                planes = cs.kmer_stream(W, -(-rows // T) * T, cs.SEED + W, payload, copies)
                time_k4d(label, planes, W, k4d_libs, args.rounds)
                del planes
                torch.cuda.empty_cache()
        if "k2" in args.kernels:
            time_k2({**libs, **{v: x for v, x in variants.items() if v.startswith("k2")}},
                    args.rounds)
    if "k4a" not in args.kernels and "k3" not in args.kernels:
        print(card, flush=True)
        return
    for R in RS:
        cs.say("attrs", kernel="bitonic_tile_sort", R=R, **bitonic.tile_sort_attrs(R))
        cs.say("attrs", kernel="bitonic_merge", R=R, **bitonic.merge_level_attrs(R))
        cs.say("attrs", kernel="radix_tile_sort", R=R, **radix.tile_sort_attrs(R))
    check_small(lib)

    T = radix.DEFAULT_TILE_ROWS * radix.LANES
    for label, W, rows, payload, copies in (("step2_W4", 4, cs.STEP2_ROWS, True, 45),
                                            ("step3_W17", 17, STEP3_K2_ROWS, False, 2)):
        if "k4a" not in args.kernels:
            break
        planes = cs.kmer_stream(W, -(-rows // T) * T, cs.SEED + W, payload, copies)
        key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
        time_k4a(label, planes, 4, key, libs, args.rounds)
        del planes, key
        torch.cuda.empty_cache()

    for label, W, n in (("step2_W4", 4, cs.STEP2_POW2), ("step3_W17", 17, 1 << 23)):
        if "k3" not in args.kernels:
            break
        planes = cs.kmer_stream(W, n, cs.SEED + 3 + W, True, 45 if W == 4 else 2)
        key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
        time_k3(label, planes, W, key, libs, args.rounds)
        del planes, key
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
