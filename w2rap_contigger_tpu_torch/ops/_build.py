"""Build and load the hand-written Hopper kernels.

Every `csrc/*.cu` is compiled by its own nvcc, all started together
(`csrc/*.cuh` are headers they include), and the objects are linked
into one shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <build>/<hash>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/<hash>/libw2rap_kernels.so <build>/<hash>/*.o

The build directory (`w2rap_contigger_tpu_torch/csrc/build/`, listed in
.gitignore) is keyed by a hash of the sources, headers and flags, so a
library is built once per source state, at first use.  A missing nvcc or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
BUILD_SECONDS: float | None = None  # wall time of the nvcc runs, if any

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry points: name -> argtypes; each returns cudaGetLastError()
_SIGNATURES = {
    "w2rap_kmerize": [_P, _I64, _I64, _P, _I32, _I32, _P, _I64, _P],
    "w2rap_kmerize_attrs": [_I32, _P],
    "w2rap_collapse": [_P, _I64, _I32, _I32, _I32, _P, _P, _P, _P],
    "w2rap_collapse_attrs": [_P],
    "w2rap_radix_tile_sort": [_P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
    "w2rap_radix_tile_sort_attrs": [_I32, _P],
    "w2rap_radix_partition": [_P, _I64, _I32, _I32, _I32, _I32, _I32,
                              _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "w2rap_radix_partition_attrs": [_P],
    "w2rap_radix_region_sort": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32,
                                _I32, _I32, _I32, _I32, _P, _I64, _I32, _I32,
                                _P, _P],
    "w2rap_radix_region_sort_attrs": [_P],
    "w2rap_radix_merge_pass": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                               _I32, _P, _I64, _I32, _I32, _P, _P],
    "w2rap_radix_merge_pass_attrs": [_P],
    "w2rap_bitonic_tile_sort": [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P],
    "w2rap_bitonic_tile_sort_attrs": [_I32, _P],
    "w2rap_bitonic_merge": [_P, _I64, _I32, _I32, _I32, _I64, _I32, _I32, _I32, _P],
    "w2rap_bitonic_merge_attrs": [_I32, _P],
    "w2rap_bitonic_cross_stage": [_P, _I64, _I32, _I32, _I64, _I64, _P],
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin/nvcc or PATH); the CUDA kernels "
        "cannot be built"
    )


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *headers()]:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + out)


def _build(srcs: list[str], out_dir: str, so_path: str) -> None:
    """One nvcc per source, all at once, then one link."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + f".{tag}.o") for s in srcs]
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)])
        tmp = f"{so_path}.{tag}"
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so_path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def library():
    """The loaded kernel library, built on first use."""
    global _LIB, BUILD_SECONDS
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        out_dir = os.path.join(BUILD_DIR, _digest(srcs))
        so_path = os.path.join(out_dir, "libw2rap_kernels.so")
        if not os.path.exists(so_path):
            os.makedirs(out_dir, exist_ok=True)
            t0 = time.time()
            _build(srcs, out_dir, so_path)
            BUILD_SECONDS = time.time() - t0
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def kernel_attrs(entry: str, *variant: int) -> dict:
    """Registers a thread, spilled (local) bytes a thread, static shared
    bytes and most threads a block of one compiled kernel (of the template
    instance `variant`, where the kernel has several), from
    cudaFuncGetAttributes through the entry point `entry` (`*_attrs`)."""
    buf = (ctypes.c_int * 4)()
    check(getattr(library(), entry)(*variant, buf), entry)
    return {"regs": buf[0], "local_bytes": buf[1], "static_smem": buf[2],
            "max_threads": buf[3]}


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
