"""K4c (region merge) and K3a (key-index tile sort) variants, checked and
timed in one process on one GPU.

    python3 scripts/sort_kernel_ab.py [--rounds 2]

Prints each kernel variant's registers, spilled (local) bytes and static
shared memory (cudaFuncGetAttributes); holds every variant bit for bit
against its plain version on small streams (K3a at W = 2, 4, 13, 17, 40
and tiles of 128..16384 rows, also with 90% of rows tied on their first
word; K4c on K4b's slots, with and without the final gather) and at step
2's and step 3's shapes (`chip_smoke.py`'s streams: 210.1M rows of 4 key
words + payload for K4c, 2^28 rows for K3a; 4,599,661 K2 rows of 17 key
words for K4c, 2^23 rows of 17 + payload for K3a); then times, at both
shapes, K4c at P = 8 and 16 records a thread and K3a at R = 2, 4, 8 and 16
rows a thread where the tile allows, in turns (a, b, ..., b, a), each a
mean of CUDA-event times over --rounds turns, beside one stable
torch.sort of the leading int64 key.  Exits non-zero on any mismatch.

The port runs K4c at P = 8 and K3a at the R that `bitonic.tile_geometry`
takes from the tile.  The other K3a variants are the kernel's own
template instances, launched here through its C entry point with another
R; the P = 16 K4c is compiled here from csrc/region_merge.cu with its P
constant replaced, into a library of its own.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build, bitonic, radix  # noqa: E402

STEP3_K2_ROWS = 4_599_661  # E. coli K=260 K2 rows (chip_smoke.py phase 6)
P_LINE = "constexpr int P = 8;"


def load_k4c(P: int, out_dir: str):
    """K4c with P records a thread, built from csrc/region_merge.cu."""
    with open(os.path.join(_build._CSRC, "region_merge.cu")) as f:
        src = f.read()
    if src.count(P_LINE) != 1:
        raise SystemExit(f"region_merge.cu no longer holds {P_LINE!r}")
    cu = os.path.join(out_dir, f"region_merge_p{P}.cu")
    so = os.path.join(out_dir, f"region_merge_p{P}.so")
    with open(cu, "w") as f:
        f.write(src.replace(P_LINE, f"constexpr int P = {P};"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-shared",
                    "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    for name in ("w2rap_radix_region_sort", "w2rap_radix_region_sort_attrs"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def k4c_attrs(lib) -> dict:
    buf = (ctypes.c_int * 4)()
    _build.check(lib.w2rap_radix_region_sort_attrs(buf), "K4c attrs")
    return {"regs": buf[0], "local_bytes": buf[1], "static_smem": buf[2],
            "max_threads": buf[3]}


def k4c_with(P: int, libs: dict, recs, region: int, C: int, run: int, final=None):
    """K4c at P records a thread: the port's wrapper at its own P, else
    the variant library, launched as radix.region_sort launches it."""
    if P == radix.MERGE_OUTPUTS:
        return radix.region_sort(*recs, region, C, run, final=final)
    m = radix.region_merge_geometry(C, run)["m"]
    total = recs[0].shape[0]
    if final:
        planes, num_keys = final
        out = torch.empty((planes.shape[0], total), dtype=torch.int32, device=planes.device)
        dst = (None, None, None)
        gather = (planes.data_ptr(), planes.shape[1], planes.shape[0], num_keys,
                  out.data_ptr())
    else:
        out = tuple(torch.empty_like(r) for r in recs)
        dst = tuple(r.data_ptr() for r in out)
        gather = (None, 0, 0, 0, None)
    err = libs[P].w2rap_radix_region_sort(
        *(r.data_ptr() for r in recs), *dst, total, region, C, run, m, m // P,
        int(bool(final)), *gather, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"K4c P={P}")
    return out


def k3a_with(planes: torch.Tensor, W: int, T: int, R: int) -> torch.Tensor:
    """K3a in place at R rows a thread, through the kernel's C entry point
    (the port's wrapper takes R from bitonic.tile_geometry)."""
    num_ops, n = planes.shape
    smem = num_ops * T * 4 + 4 * T
    err = _build.library().w2rap_bitonic_tile_sort(
        planes.data_ptr(), n, num_ops, W, T, R, T // R, smem,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"K3a R={R}")
    return planes


def k3a_variants(T: int, num_ops: int) -> list[int]:
    """The R a T-row tile of num_ops planes can run at."""
    fits = num_ops * T * 4 + 4 * T <= bitonic.SMEM_MAX_BYTES
    return [R for R in (2, 4, 8, 16) if fits and 32 <= T // R <= bitonic.TILE_THREADS]


def check_k3a_small() -> None:
    for W in (1, 2, 4, 13, 17, 40):
        T = 128
        while T <= 16384:
            for R in k3a_variants(T, W + 1):
                for tie_first in (0.0, 0.9):
                    planes = cs.tie_stream(W, 4 * T, W * T + R, tie_first)
                    got = k3a_with(planes.clone(), W, T, R)
                    want = bitonic.tile_sort_plain(planes, W, T)
                    if not torch.equal(got, want):
                        cs.fail(f"K3a W={W} T={T} R={R} tie_first={tie_first} differs")
            T *= 2
    cs.say("k3a_small", identical=True)


def k4c_inputs(planes: torch.Tensor, num_keys: int, cmp_keys: int):
    T, n_tiles, n_bins, cap, region = radix.geometry(planes.shape[1])
    s = radix.tile_sort(planes, cmp_keys, T)
    sp = radix.splitters(s[0], s[1], T, n_bins)
    *recs, _ = radix.partition(planes, *s, *sp, num_keys, cmp_keys, T, n_bins, cap)
    C = min(T, region)
    return recs, region, C, min(cap, C)


def check_k4c(label: str, planes: torch.Tensor, num_keys: int, cmp_keys: int, libs: dict):
    recs, region, C, run = k4c_inputs(planes, num_keys, cmp_keys)
    want = radix.region_sort_plain(*recs, region, C)
    want_final = radix.gather_plain(want[2], planes, num_keys)
    for P in (8, 16):
        got = k4c_with(P, libs, recs, region, C, run)
        fin = k4c_with(P, libs, recs, region, C, run, final=(planes, num_keys))
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or not torch.equal(fin, want_final):
            cs.fail(f"K4c {label} P={P} differs from its plain version")
        del got, fin
    del want, want_final
    torch.cuda.empty_cache()
    g = radix.region_merge_geometry(C, run)
    cs.say("k4c_check", case=label, rows=planes.shape[1], region=region, C=C, run=run,
           levels=g["levels"], identical=True)
    return recs, region, C, run


def turns(fns: dict, rounds: int) -> dict:
    """Mean ms of each fn over rounds turns of (a, b, ..., b, a)."""
    names = list(fns)
    acc = {k: [] for k in names}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for k in names + names[::-1]:
            acc[k].append(cs.time_ms(fns[k], reps=1))
    return {k: sum(v) / len(v) for k, v in acc.items()}


def time_k4c(label: str, recs, region, C, run, key, rounds: int, libs: dict) -> None:
    fns = {f"P{P}": (lambda P=P: k4c_with(P, libs, recs, region, C, run)) for P in (8, 16)}
    fns["torch_sort"] = lambda: torch.sort(key, stable=True)
    for k, ms in turns(fns, rounds).items():
        cs.say("k4c_time", case=label, variant=k, ms=f"{ms:.4f}")


def time_k3a(label: str, planes: torch.Tensor, W: int, key, rounds: int) -> None:
    T = bitonic.tile_rows_of(planes.shape[0], planes.shape[1])
    buf = planes.clone()
    want = bitonic.tile_sort_plain(planes, W, T)
    fns = {}
    for R in k3a_variants(T, planes.shape[0]):
        buf.copy_(planes)
        if not torch.equal(k3a_with(buf, W, T, R), want):
            cs.fail(f"K3a {label} R={R} differs from its plain version")

        def run(R=R):
            buf.copy_(planes)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            k3a_with(buf, W, T, R)
            t1.record()
            return t0, t1
        fns[f"R{R}"] = run
    del want
    torch.cuda.empty_cache()
    names = list(fns)
    acc = {k: [] for k in names}
    for _ in range(rounds + 1):
        for k in names + names[::-1]:
            t0, t1 = fns[k]()
            torch.cuda.synchronize()
            acc[k].append(t0.elapsed_time(t1))
    for k in names:
        v = acc[k][2:]  # the first turn warms up
        cs.say("k3a_time", case=label, tile=T, variant=k, ms=f"{sum(v) / len(v):.4f}")
    lib = turns({"torch_sort": lambda: torch.sort(key, stable=True)}, rounds)["torch_sort"]
    cs.say("k3a_time", case=label, tile=T, variant="torch_sort", ms=f"{lib:.4f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = cs.phase_probe()
    cs.phase_build()
    out_dir = os.path.join(_build.BUILD_DIR, f"ab.{os.getpid()}")
    os.makedirs(out_dir)
    try:
        libs = {16: load_k4c(16, out_dir)}
        cs.say("attrs", kernel="radix_region_sort", P=8, **radix.region_sort_attrs())
        cs.say("attrs", kernel="radix_region_sort", P=16, **k4c_attrs(libs[16]))
        for R in (2, 4, 8, 16):
            cs.say("attrs", kernel="bitonic_tile_sort", R=R, **bitonic.tile_sort_attrs(R))
        check_k3a_small()
        small = cs.kmer_stream(5, 8 * 8192, cs.SEED + 5, True, 3)
        check_k4c("small_W5", small, 5, 4, libs)
        del small

        T = radix.DEFAULT_TILE_ROWS * radix.LANES
        for label, W, rows, payload, copies in (("step2_W4", 4, cs.STEP2_ROWS, True, 45),
                                                ("step3_W17", 17, STEP3_K2_ROWS, False, 2)):
            planes = cs.kmer_stream(W, -(-rows // T) * T, cs.SEED + W, payload, copies)
            recs, region, C, run = check_k4c(label, planes, W, 4, libs)
            key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
            del planes
            torch.cuda.empty_cache()
            time_k4c(label, recs, region, C, run, key, args.rounds, libs)
            del recs, key
            torch.cuda.empty_cache()

        for label, W, n in (("step2_W4", 4, cs.STEP2_POW2), ("step3_W17", 17, 1 << 23)):
            planes = cs.kmer_stream(W, n, cs.SEED + 3 + W, True, 45 if W == 4 else 2)
            key = bk.pair_key(bk.from_raw32(planes[0]), bk.from_raw32(planes[1]))
            time_k3a(label, planes, W, key, args.rounds)
            del planes, key
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir)
    print(card, flush=True)


if __name__ == "__main__":
    main()
