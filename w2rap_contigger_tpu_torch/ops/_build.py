"""Build and load the hand-written Hopper kernels.

Every `csrc/*.cu` is compiled by nvcc into one shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/<hash>/libw2rap_kernels.so csrc/*.cu

The build directory (`w2rap_contigger_tpu_torch/csrc/build/`, listed in
.gitignore) is keyed by a hash of the sources and flags, so a library is
built once per source state, at first use.  A missing nvcc or a failed
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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB = None
BUILD_SECONDS: float | None = None  # wall time of the nvcc run, if any

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry points: name -> argtypes; each returns cudaGetLastError()
_SIGNATURES = {
    "w2rap_kmerize": [_P, _I64, _I64, _P, _I32, _I32, _P, _I64, _P],
    "w2rap_collapse": [_P, _I64, _I32, _I32, _I32, _P, _P, _P, _P],
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


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


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
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            t0 = time.time()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    "nvcc failed:\n" + " ".join(cmd) + "\n" + res.stdout + res.stderr
                )
            os.replace(tmp, so_path)
            BUILD_SECONDS = time.time() - t0
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
