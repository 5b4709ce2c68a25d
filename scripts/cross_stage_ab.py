"""A/B of five forms of the bitonic cross pass, in one process on one GPU.

    python3 scripts/cross_stage_ab.py [--rounds 2]

The port's `cross_stage_kernel` (csrc/bitonic.cu: in place, the swap's
loads of 4 planes before their stores, at most 32 registers) against
four forms compiled here from the source below: `two_pointer` (src and
dst pointers, called with src == dst, selects on the swap flag),
`one_plane` (in place, one plane's load and store at a time),
`two_pointer_swaps` (src and dst pointers, called with src == dst,
returning early when the pair does not swap) and `batch8` (in place, 8
planes' loads before their stores, registers not capped).  Each form
runs every cross pass of a whole sort (the tile and merge passes are the
port's), on the streams of `chip_smoke.py` phase 3c at step 2's shape
(2^28 rows, 4 key words + payload) and step 3's (2^23 rows, 17 +
payload); the result must equal the port's sort.  Prints each form's
mean ms a cross pass, in the order of FORMS, repeated --rounds times.
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
from w2rap_contigger_tpu_torch.ops import _build, bitonic  # noqa: E402

SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ bool greater_at(const uint32_t* p, int64_t n,
                                           int num_keys, int64_t a, int64_t b) {
  for (int j = 0; j < num_keys; ++j) {
    const uint32_t x = p[j * n + a], y = p[j * n + b];
    if (x != y) return x > y;
  }
  return false;
}

__global__ void two_pointer(const uint32_t* src, uint32_t* dst, int64_t n,
                            int num_ops, int num_keys, int64_t stride,
                            int64_t size) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int64_t b = a + stride;
  const bool swap = greater_at(src, n, num_keys, a, b) != ((a & size) != 0);
  if (!swap && src == dst) return;
  for (int j = 0; j < num_ops; ++j) {
    const uint32_t x = src[j * n + a], y = src[j * n + b];
    dst[j * n + a] = swap ? y : x;
    dst[j * n + b] = swap ? x : y;
  }
}

__global__ void one_plane(uint32_t* planes, int64_t n, int num_ops,
                          int num_keys, int64_t stride, int64_t size) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int64_t b = a + stride;
  if (greater_at(planes, n, num_keys, a, b) == ((a & size) != 0)) return;
  for (int j = 0; j < num_ops; ++j) {
    const uint32_t x = planes[j * n + a];
    planes[j * n + a] = planes[j * n + b];
    planes[j * n + b] = x;
  }
}

__global__ void two_pointer_swaps(const uint32_t* src, uint32_t* dst, int64_t n,
                                  int num_ops, int num_keys, int64_t stride,
                                  int64_t size) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int64_t b = a + stride;
  if (greater_at(src, n, num_keys, a, b) == ((a & size) != 0)) return;
  for (int j = 0; j < num_ops; ++j) {
    const uint32_t x = src[j * n + a], y = src[j * n + b];
    dst[j * n + a] = y;
    dst[j * n + b] = x;
  }
}

__global__ void batch8(uint32_t* planes, int64_t n, int num_ops, int num_keys,
                       int64_t stride, int64_t size) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int64_t b = a + stride;
  if (greater_at(planes, n, num_keys, a, b) == ((a & size) != 0)) return;
  for (int j0 = 0; j0 < num_ops; j0 += 8) {
    uint32_t x[8], y[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < num_ops) {
        x[u] = planes[(j0 + u) * n + a];
        y[u] = planes[(j0 + u) * n + b];
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < num_ops) {
        planes[(j0 + u) * n + a] = y[u];
        planes[(j0 + u) * n + b] = x[u];
      }
  }
}

extern "C" int ab_cross(int form, void* planes, int64_t n, int num_ops,
                        int num_keys, int64_t stride, int64_t size,
                        void* stream) {
  const unsigned blocks = (unsigned)(((n >> 1) + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* p = static_cast<uint32_t*>(planes);
  if (form == 0)
    two_pointer<<<blocks, 256, 0, s>>>(p, p, n, num_ops, num_keys, stride, size);
  else if (form == 1)
    one_plane<<<blocks, 256, 0, s>>>(p, n, num_ops, num_keys, stride, size);
  else if (form == 2)
    two_pointer_swaps<<<blocks, 256, 0, s>>>(p, p, n, num_ops, num_keys, stride, size);
  else
    batch8<<<blocks, 256, 0, s>>>(p, n, num_ops, num_keys, stride, size);
  return (int)cudaGetLastError();
}
"""

FORMS = ("port", "two_pointer", "one_plane", "two_pointer_swaps", "batch8")


def load(out_dir: str):
    src = os.path.join(out_dir, "ab.cu")
    so = os.path.join(out_dir, "ab.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.ab_cross.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.ab_cross.restype = ctypes.c_int
    return lib


def sort_with(form: str, lib, planes: torch.Tensor, num_keys: int, T: int):
    """A copy of planes sorted with `form` for the cross passes: (the
    result, mean ms a cross pass)."""
    buf = planes.clone()
    marks = []
    stream = torch.cuda.current_stream().cuda_stream
    for kind, x, size in bitonic.phases(buf.shape[1], T):
        if kind == "tile":
            bitonic.tile_sort(buf, num_keys, T)
        elif kind == "merge":
            bitonic.merge_level(buf, num_keys, T, size)
        else:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            if form == "port":
                bitonic.cross_stage(buf, num_keys, x, size)
            else:
                err = lib.ab_cross(FORMS.index(form) - 1, buf.data_ptr(), buf.shape[1],
                                   buf.shape[0], num_keys, x, size, stream)
                _build.check(err, f"ab_cross {form}")
            t1.record()
            marks.append((t0, t1))
    torch.cuda.synchronize()
    return buf, sum(t0.elapsed_time(t1) for t0, t1 in marks) / len(marks)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    out_dir = os.path.join(_build.BUILD_DIR, f"ab.{os.getpid()}")
    os.makedirs(out_dir)
    try:
        lib = load(out_dir)
        for label, num_keys, n, seed, copies in (("step2_W4", 4, cs.STEP2_POW2, cs.SEED + 3, 45),
                                                 ("step3_W17", 17, 1 << 23, cs.SEED + 18, 2)):
            planes = cs.kmer_stream(num_keys, n, seed, True, copies)
            T = bitonic.tile_rows_of(planes.shape[0], n)
            want = bitonic.bitonic_sort(planes.clone(), num_keys)
            for rnd in range(args.rounds):
                for form in FORMS:
                    got, ms = sort_with(form, lib, planes, num_keys, T)
                    same = torch.equal(got, want)
                    del got
                    print(f"[cross_ab] case={label} round={rnd} form={form} "
                          f"ms_per_pass={ms:.4f} same_as_port_sort={same}", flush=True)
                    if not same:
                        raise SystemExit(f"{form} gives another sort")
            del planes, want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir)


if __name__ == "__main__":
    main()
