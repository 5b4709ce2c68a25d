"""K3a, K3b and K4a (the kernels on csrc/keyindex_net.cuh) checked and
timed in one process on one GPU, optionally beside another checkout's.

    python3 scripts/sort_kernel_ab.py [--parent DIR ...] [--rounds 2]

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

The port runs each kernel at the R that `bitonic.tile_geometry` takes
from the tile; the other R are the kernels' own template instances,
launched here through their C entry points.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build, bitonic, radix  # noqa: E402

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="*", default=[],
                    help="unpacked checkouts of other commits of the port")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = cs.phase_probe()
    cs.phase_build()
    lib = _build.library()
    libs = {"new": lib, **{os.path.basename(os.path.normpath(d)): load_parent(d)
                           for d in args.parent}}
    for R in RS:
        cs.say("attrs", kernel="bitonic_tile_sort", R=R, **bitonic.tile_sort_attrs(R))
        cs.say("attrs", kernel="bitonic_merge", R=R, **bitonic.merge_level_attrs(R))
        cs.say("attrs", kernel="radix_tile_sort", R=R, **radix.tile_sort_attrs(R))
    check_small(lib)

    T = radix.DEFAULT_TILE_ROWS * radix.LANES
    for label, W, rows, payload, copies in (("step2_W4", 4, cs.STEP2_ROWS, True, 45),
                                            ("step3_W17", 17, STEP3_K2_ROWS, False, 2)):
        planes = cs.kmer_stream(W, -(-rows // T) * T, cs.SEED + W, payload, copies)
        key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
        time_k4a(label, planes, 4, key, libs, args.rounds)
        del planes, key
        torch.cuda.empty_cache()

    for label, W, n in (("step2_W4", 4, cs.STEP2_POW2), ("step3_W17", 17, 1 << 23)):
        planes = cs.kmer_stream(W, n, cs.SEED + 3 + W, True, 45 if W == 4 else 2)
        key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
        time_k3(label, planes, W, key, libs, args.rounds)
        del planes, key
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
