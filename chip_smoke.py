"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--work DIR]   # needs one NVIDIA GPU

Phases, each printing its results on a line of its own; any failure
exits non-zero and prints no result line:

1. probe the card (torch.cuda, nvidia-smi name and power limit);
2. build the CUDA kernels from csrc/ with nvcc, and the host C++ leaves
   of step 5's blob-local graphs (native/{count,graph,path}_kernel.cc)
   with g++;
3. each kernel against its plain PyTorch version, element by element, on
   the card at the main path's shapes (K1 kmerize on one 65536-read chunk
   at k=60 and k=200, L=250, timed over 50 launches into one output, and
   on small ragged inputs at k = 31, 272, 320 and 640, with its registers
   and spills at W = 4, 13, 17, 40; K2 collapse on sorted W=4 and W=13 streams
   with cross-tile runs, runs longer than a tile, counts above 255 and
   sentinels, and on a W=17 stream in the partition sort's layout, with
   sentinel runs mid-stream, and on a W=4 stream whose 100k-row run has
   one ctx value, so that the run never saturates), with both times,
   bounds (the whole output written) and K1's and K2's registers and spills;
3b. K4a-d (the partition sort) against their plain versions, kernel by
   kernel and whole, bit-identical: K4a (the key-index tile sort,
   csrc/radix.cu on csrc/keyindex_net.cuh) first alone at cmp_keys 1-4
   on odd tile counts of tie-heavy rows, with rows all ones in the
   comparator words; then (a) step 2's shape, 210.1M rows of
   4 key words + payload; (b) step 3's shape at K=260, 17 key words with
   ctx in the pad bits, at the row count phase 6 counted (8% sentinel
   rows mid-stream), and (c) the planes step 3 of phase 6's radix run
   handed to the partition sort (a few padding rows a tile); K4b (a
   block a tile and bin) with its tail rows, share of the bound,
   registers and spills (its first form is timed beside it by
   scripts/sort_kernel_ab.py --kernels k4b --parent); K4c (the merge
   of K4b's sorted slots, csrc/region_merge.cu) also with its final
   gather; K4d (the merge path by the block) at its first level and at
   its last, as records and gathering; each kernel's time (K4d's mean
   over the sort's levels, each level's printed), its plain version's,
   its bound, and one stable torch.sort of the leading int64 key as the
   library yardstick; K4a's, K4c's and K4d's launch geometry, registers,
   spills and shared bytes;
   plus a skewed stream and one with real rows all ones in the
   comparator words, which must both raise the overflow flag;
3c. K3a (the key-index tile sort, csrc/bitonic_tile.cu), the cross stage
   and K3b (the key-index merge level, csrc/bitonic.cu; both on
   csrc/keyindex_net.cuh) against their plain versions, phase by phase
   and whole, bit-identical: K3a and K3b first alone at W = 2, 4, 13, 17,
   40 on tiles of 128..8192 rows, on tie-heavy rows and on rows of which
   90% share their first word; then (a) step 2's shape, 2^28 rows of 4
   key words + payload; (b) step 3's, the power of two above phase 6's
   K2 rows, 17 key words + payload; each kernel's mean time a launch in
   one in-place sort, its launches in that sort, its plain version's
   time, its bound (a cross pass: the key words its pairs compare and the
   rows it swaps, counted on the data), one stable torch.sort of the
   leading int64 key as the library yardstick, K3a's and K3b's launch
   geometry, registers, spills and shared bytes, and the in-place sort's
   peak device memory;
3d. the port's benchmark (python -m w2rap_contigger_tpu_torch.bench:
   step 2's count chain, K1 -> sort -> K2 + compaction, on bench.py's
   131,072 synthetic reads) in a subprocess under W2RAP_SORT=lax, radix,
   then pallas, each JSON line printed: every back end's chain equal to
   its count_kmers_device run, the three dictionaries equal, K1
   launched twice and K2 once a chain, the sort's kernels launched, no
   radix recount; then ops.align.banded_costs_batch on the card against
   the same call on the CPU (B = 256, Ls = Lt = 250, bandwidth 16):
   equal;
4. step 2 through the port's CLI entry on a 200 kb genome / 24k PE250
   pairs, --device cuda against --device cpu: small_K.freqs, HBV and
   paths must be identical;
4b. steps 1-4 (K=200, --min_freq 2) at 200 kb under W2RAP_SORT=pallas,
   --device cuda against --device cpu: the small_K, large_K and
   large_K.clean checkpoints must be identical, every K3 kernel launched,
   and Clean200x must delete edges (the kept sequencing errors branch the
   graph); its seconds printed;
4c. steps 1-7 (K=200) on the repeat-rich 500 kb genome of
   scripts/parity_repeat.sh (12 copies of a 3 kb repeat, 4 coverage
   dips, 60k PE250 pairs, seed 7) under the default sort, --device cuda
   against --device cpu: every checkpoint through large_K.final and
   every file of steps 6-7 (pe.contig.*, a.lines.fasta, stats,
   a.fin.frags.dist, the a_contigs and pe_assembly GFA files) must be
   identical, step 5 must solve a blob and add a piece, K2 (collapse)
   must launch inside step 5 (AddNewStuff's count) and no kernel in
   steps 6-7; the blob and piece counts, the AssembleGaps, Simplify and
   MakeGaps+FinalFiles seconds, the step 5-7 split on both devices, the
   line count and N50 printed;
4d. step 2 with --fill_join on scripts/parity_filljoin.sh's low-coverage
   200 kb genome (10k PE250 pairs, seed 11), --device cuda against
   --device cpu: small_K.freqs and the small_K checkpoints identical, and
   different from the card's run without --fill_join; the edge counts,
   seconds and the fill_gaps / join_overlaps spans printed;
5. step 2 at E. coli scale (4.6 Mbp, 550k PE250 pairs, seed 42) on the
   card with W2RAP_TIMELOG=1: both kernels launched, graph and paths
   validated, step split, the count's and the run's peak device memory
   printed;
5b. the same with -d 4 -m 4 --tmp_dir (at least 4 hash ranges, as many
   as the 4 GiB ceiling needs, each spilled): small_K.freqs and the
   small_K checkpoints identical to phase 5's, the spill directory empty
   afterwards, the count's peak device memory within 4 GiB and below
   phase 5's, K2 launched R times phase 5's and K1 R + 1 times (the
   ranges' sizing pass and one pass a range; R the sorts the count's
   timelog records); both peaks, the count's split and the launches
   printed;
6. steps 1-4 at E. coli scale with K=260 on the card, three times:
   W2RAP_SORT=lax, radix, then pallas.  The checkpoints of the three runs
   must be identical, every K4 kernel launched in step 2 and in step 3 of
   the radix run with no exact recount, every K3 kernel in step 2 and in
   step 3 of the pallas run, HBV and paths validated; the step-3 and
   step-4 split, the K2 rows, the unique K2 kmers and the peak device
   memory printed; the input reads and the lax run's small_K.freqs and
   frag_reads_orig, small_K, large_K and large_K.clean arrays must
   have the sha256 of the JAX package's run on the same data
   (EXPECTED, written by scripts/port_parity.sh ecoli through
   scripts/output_hashes.py);
5c. steps 1-3 sharded over a mesh of 4 logical shards of the card
   ([cuda:0] x 4, `run_pipeline(mesh=)`): (a) on phase 4's 200 kb data
   at K=200 under lax, radix and pallas, each against the card's
   unsharded lax run (small_K.freqs, the small_K and large_K
   checkpoints identical; K1 and K2 launched on every shard, K4 or K3
   under radix or pallas); (b) at E. coli scale, K=260, lax, against
   phase 6's lax run: the rows each shard owns (max / mean), the bytes
   exchanged, K1 and K2 launches, step2.count with its .exchange,
   SmallKGraph, RepathInMemory and the count's peak device memory
   beside phase 5's printed; (c) with two cards or more, (b) again
   through the CLI's --shard over the real cards, else real_cards=1;
7. steps 1-7 at E. coli scale with gaps (4.6 Mbp, 550k PE250 pairs, 12
   copies of a 3 kb repeat, 8 coverage dips, seed 7) at K=260 on the
   card: graph and paths validated, no kernel launched in steps 6-7,
   the .perf walls, the step 5-7 split (step5.unsat, .blobs,
   .add_new_stuff and its layers, .partners; step6.reroute, .passes,
   .pullaparter, .improve, .ext_final, .tail, .outputs, .classify;
   step7.make_gaps, .final_files), the blobs and pieces, the contig
   count, N50 and gaps added, the peak device memory and the kernel
   launches of step 5 and of steps 6-7 printed; the input reads,
   small_K.freqs, the frag_reads_orig, pe.contig and pe_assembly
   arrays and every step 6-7 file must have the sha256 of the JAX
   package's run (EXPECTED, from scripts/port_parity.sh ecoli_gaps);
   then the port's hbv2gfa on pe.contig, its stats printed.

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
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from w2rap_contigger_tpu_torch import __main__ as cli  # noqa: E402
from w2rap_contigger_tpu_torch import hbv2gfa  # noqa: E402
from w2rap_contigger_tpu_torch import device as tdev  # noqa: E402
from w2rap_contigger_tpu_torch.graph import build as gb  # noqa: E402
from w2rap_contigger_tpu_torch.graph import validate  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitonic  # noqa: E402
from w2rap_contigger_tpu_torch.ops import collapse as kcol  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmerize as kkm  # noqa: E402
from w2rap_contigger_tpu_torch.ops import radix  # noqa: E402
from w2rap_contigger_tpu_torch import native  # noqa: E402
from w2rap_contigger_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from w2rap_contigger_tpu_torch.paths import flat_pather, pather  # noqa: E402
from w2rap_contigger_tpu_torch.pipeline import step3_repath, step5_gaps  # noqa: E402
from w2rap_contigger_tpu_torch.pipeline.driver import run_pipeline  # noqa: E402
from w2rap_contigger_tpu_torch.pipeline import step6_simplify, step7_scaffold  # noqa: E402
from w2rap_contigger_tpu_torch.utils import sysinfo  # noqa: E402
from w2rap_contigger_tpu_torch.ops import align  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "scripts"))
from output_hashes import output_hashes, reads_hashes  # noqa: E402

DEV = "cuda"
SEED = 42
CHUNK_READS = 65536
READ_LEN = 250
ECOLI = {"glen": 4_600_000, "pairs": 550_000}
SMALL = {"glen": 200_000, "pairs": 24_000}
# scripts/parity_repeat.sh's data, and E. coli scale with gaps
REPEAT = {"glen": 500_000, "pairs": 60_000, "seed": 7,
          "extra": ("--repeats", "12", "--repeat_len", "3000", "--dips", "4")}
# scripts/parity_filljoin.sh's low-coverage genome (12x): captured gaps
FILL_JOIN = {"glen": 200_000, "pairs": 10_000, "seed": 11}
ECOLI_GAPS = {"glen": 4_600_000, "pairs": 550_000, "seed": 7,
              "extra": ("--repeats", "12", "--repeat_len", "3000", "--dips", "8")}
NATIVE_LEAVES = (("w2rapcount", "count_kernel.cc"), ("w2rapgraph", "graph_kernel.cc"),
                 ("w2rappath", "path_kernel.cc"))
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
FINAL = ("pe.large_K.final.hbv.npz", "pe.large_K.final.paths.npz")
CONTIG = ("pe.contig.hbv.npz", "pe.contig.paths.npz")
# what steps 6-7 write; pe_assembly.* only when MakeGaps adds a gap
STEP67_FILES = CONTIG + ("a.lines.fasta", "stats", "a.fin.frags.dist", "a_contigs_raw.gfa",
                         "a_contigs_lines.gfa", "pe_assembly_raw.gfa", "pe_assembly_lines.gfa")
ASSEMBLY = ("pe_assembly.hbv.npz", "pe_assembly.paths.npz")


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
    t0 = time.time()
    for name, src in NATIVE_LEAVES:
        if native.load(name, [src], libs=["pthread"]) is None:
            fail(f"the host leaf native/{src} did not build")
    say("build_native", seconds=f"{time.time() - t0:.2f}", leaves=len(NATIVE_LEAVES))


# ---------------------------------------------------------------------------
# phase 3: K1 and K2 against their plain versions
# ---------------------------------------------------------------------------


def _reads(rng, n, L):
    bases = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lengths = rng.integers(L - 40, L + 1, size=n).astype(np.int32)
    quals = rng.integers(30, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.02] = 2
    return bases, lengths, quals


K1_REPS = 50  # K1 launches timed between two CUDA events
# (k, L) of K1's small ragged checks: W = 2, 17, 20, 40, each on 300 and
# 301 reads (the planes 16-byte aligned, then not), reads shorter than k
K1_SMALL = ((31, 340), (272, 660), (320, 660), (640, 700))
K1_ATTRS_W = (4, 13, 17, 40)


def kmerize_c(lib, pr_d, gl_d, k: int, L: int, out) -> None:
    """One launch of a kernel library's K1 into out, through its C entry
    (not the wrapper: not counted)."""
    n = pr_d.shape[0]
    _build.check(lib.w2rap_kmerize(
        pr_d.data_ptr(), n, pr_d.shape[1], gl_d.data_ptr(), k, L - k + 1,
        out.data_ptr(), n * (L - k + 1), torch.cuda.current_stream().cuda_stream),
        "w2rap_kmerize")


def k1_inputs(k: int, n: int = CHUNK_READS, L: int = READ_LEN, ragged: bool = False):
    """Packed rows and usable lengths on the card: one step-2 chunk, or
    (ragged) a few reads of L..k/2 bases with rare low-quality bases."""
    rng = np.random.default_rng(SEED + k + n)
    if ragged:
        bases = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
        lengths = rng.integers(k // 2, L + 1, size=n).astype(np.int32)
        quals = rng.integers(30, 41, size=(n, L)).astype(np.uint8)
        quals[rng.random((n, L)) < 0.0005] = 2
    else:
        bases, lengths, quals = _reads(rng, n, L)
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, k, 7)
    return torch.from_numpy(pr.view(np.int32)).to(DEV), torch.from_numpy(glen).to(DEV)


def check_kmerize(k: int):
    pr_d, gl_d = k1_inputs(k)
    got = kkm.kmerize(pr_d, gl_d, k, READ_LEN)
    want = kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err or not torch.equal(got, want):
        fail(f"K1 kmerize k={k} differs from its plain version (max_abs_err {err})")
    # K1_REPS launches into one preallocated output, after a warm-up
    lib = _build.library()
    out = torch.empty_like(got)
    ms = time_ms(lambda: kmerize_c(lib, pr_d, gl_d, k, READ_LEN, out), K1_REPS)
    if not torch.equal(out, want):
        fail(f"K1 kmerize k={k}: the timed launches differ from the plain version")
    plain_ms = time_ms(lambda: kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN))
    valid = int((got[0] != -1).sum())
    # the output write is the bound: W+1 planes, against the packed rows
    b, by = bound_ms(got.numel() * 4 + pr_d.numel() * 4 + gl_d.numel() * 4)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": by, "library_ms": None}
    attrs = kkm.kmerize_attrs(bk.nwords(k))
    say("kmerize", k=k, reads=CHUNK_READS, L=READ_LEN, rows=got.shape[1],
        valid_rows=valid, **fmt(res), share=f"{b / ms:.3f}", reps=K1_REPS,
        regs=attrs["regs"], local_bytes=attrs["local_bytes"])
    return res


def check_kmerize_small():
    """K1 bit for bit against its plain version on small ragged inputs at
    W = 2..40, then its registers and spills."""
    cases = 0
    for k, L in K1_SMALL:
        for n in (300, 301):
            pr_d, gl_d = k1_inputs(k, n, L, ragged=True)
            got = kkm.kmerize(pr_d, gl_d, k, L)
            want = kkm.kmerize_plain(pr_d, gl_d, k, L)
            if not torch.equal(got, want):
                fail(f"K1 kmerize k={k} L={L} n={n} differs from its plain version "
                     f"(max_abs_err {max_abs_err([got], [want])})")
            if not (want[0] != -1).any():
                fail(f"K1 small check k={k} L={L} n={n} has no valid window")
            cases += 1
    say("kmerize_small", cases=cases, k=",".join(str(k) for k, _ in K1_SMALL), identical=True)
    for W in K1_ATTRS_W:
        say("kmerize_attrs", W=W, **kkm.kmerize_attrs(W))


def sorted_stream(W: int, n: int, seed: int, regions: int = 0,
                  one_ctx: bool = False) -> torch.Tensor:
    """(W+1, n) int32 sorted stream: real rows in segments whose lengths
    mix typical coverage (1..60), repeats longer than a tile (5000..20000
    rows) and one run above 100k rows; payload cnt 1..3 so sums pass 255;
    then all-ones sentinel rows with payload 0.  With regions > 0 the real
    rows are cut at segment bounds into that many regions of n/regions
    rows, each followed by a run of sentinels: the partition sort's
    layout.  With one_ctx the 100k-row run's ctx is one value, so its
    payload never saturates and K2 walks back over all of it."""
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
    if one_ctx:
        ctx[: int(seg[0])] = 0x24
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


def check_collapse(W: int, n: int, min_count: int, regions: int = 0,
                   one_ctx: bool = False):
    planes = sorted_stream(W, n, SEED + W, regions, one_ctx)
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
    # the input read + every output row written (kept rows and fill) +
    # the tile counts
    b, by = bound_ms(2 * planes.numel() * 4 + got[1].numel() * 4)
    res = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
           "bound_by": by, "library_ms": None}
    say("collapse", W=W, rows=n, regions=regions, min_count=min_count,
        one_ctx=one_ctx, kept=kept, low_bins=got[2][1:min_count].tolist(), **fmt(res))
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
    geo = bitonic.tile_geometry(T, cmp_keys)
    say("radix_geometry", case=label, kernel="radix_tile_sort", tile=T, **geo,
        **radix.tile_sort_attrs(geo["R"]))

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
    say("radix_k4b", case=label, rows=n, tiles=n_tiles, bins=n_bins, cap=cap,
        tail_rows=n_full, ms=f"{ms:.4f}", bound_ms=f"{b:.4f}", share=f"{b / ms:.3f}",
        **radix.partition_attrs())
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

    # K4d: the first level and the last (as records, and gathering the
    # planes as the sort runs it) against their plain versions; the time
    # is the mean of every level as the sort runs them, each level's
    # printed too
    one = radix.merge_pass(*got, region, widths[0])
    err = max_abs_err(one, radix.merge_pass_plain(*got, region, widths[0]))
    del one
    plain_ms = time_ms(lambda: radix.merge_pass_plain(*got, region, widths[0]), reps=1)
    r = got
    for w in widths[:-1]:
        r = radix.merge_pass(*r, region, w)
    want = radix.merge_pass_plain(*r, region, widths[-1])
    err = max(err, max_abs_err(radix.merge_pass(*r, region, widths[-1]), want))
    fin = radix.merge_pass(*r, region, widths[-1], final=(planes, num_keys))
    err = max(err, max_abs_err([fin], [radix.gather_plain(want[2], planes, num_keys)]))
    del r, want, fin
    torch.cuda.empty_cache()
    level_ms = []

    def levels():
        r = got
        marks = []
        for i, w in enumerate(widths):
            last = i == len(widths) - 1
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            r = radix.merge_pass(*r, region, w, final=(planes, num_keys) if last else None)
            t1.record()
            marks.append((t0, t1))
        torch.cuda.synchronize()
        level_ms[:] = [a.elapsed_time(b) for a, b in marks]
        return r

    ms = time_ms(levels, reps=1) / len(widths)
    geo = radix.merge_pass_geometry(widths[0])
    say("radix_geometry", case=label, kernel="radix_merge_pass", width=widths[0], **geo,
        **radix.merge_pass_attrs())
    say("radix_levels", case=label, kernel="radix_merge_pass",
        widths=",".join(str(w) for w in widths),
        ms=",".join(f"{x:.4f}" for x in level_ms))
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


def check_radix_tiles():
    """K4a alone against its plain version at cmp_keys 1-4 on 3 and 5
    tiles of 128, 2048 and 8192 rows: tie-heavy rows of 5 key words, rows
    90% tied on their first word, and 5% of rows all ones in their
    comparator words only (they must end each tile, in row order)."""
    cases = 0
    for cmp_keys in (1, 2, 3, 4):
        for T, tiles in ((128, 5), (2048, 3), (8192, 3)):
            for tie_first in (0.0, 0.9):
                planes = tie_stream(5, T * tiles, SEED + 31 * T + cmp_keys, tie_first)
                g = torch.Generator(device=DEV)
                g.manual_seed(SEED + cmp_keys)
                full = torch.rand(T * tiles, device=DEV, generator=g) < 0.05
                planes[:cmp_keys, full] = -1
                got = radix.tile_sort(planes, cmp_keys, T)
                want = radix.tile_sort_plain(planes, cmp_keys, T)
                err = max_abs_err(got, want)
                if err:
                    fail(f"K4a cmp_keys={cmp_keys} T={T} tie_first={tie_first} differs "
                         f"from its plain version (max_abs_err {err})")
                cases += 1
    say("radix_tiles", cmp_keys="1..4", tiles="128,2048,8192", cases=cases, identical=True)


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
    """K3a, and K3b at levels 2T and 4T, alone against their plain
    versions at W = 2, 4, 13, 17, 40 on every tile of 128..8192 rows whose
    planes and indices fit one block, four tiles each, on tie-heavy rows
    and on rows 90% tied on their first word."""
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
                for size in (2 * T, 4 * T):
                    got = bitonic.merge_level(planes.clone(), W, T, size)
                    if not torch.equal(got, bitonic.merge_level_plain(planes, W, T, size)):
                        fail(f"K3b W={W} T={T} size={size} tie_first={tie_first} differs "
                             f"from its plain version")
                cases += 1
            T *= 2
    say("bitonic_tiles", kernels="K3a,K3b", widths="2,4,13,17,40", tiles="128..8192",
        cases=cases, identical=True)


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
    say("bitonic_geometry", case=label, kernel="bitonic_merge", tile=T, **geo,
        **bitonic.merge_level_attrs(geo["R"]))

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
# phase 3d: the port's benchmark under each sort; banded_costs_batch
# ---------------------------------------------------------------------------

BENCH_SORT_KERNELS = {"lax": (), "radix": K4, "pallas": K3}
BENCH_CHUNKS = 2  # bench.py's 131,072 reads in chunks of CHUNK_READS


def phase_bench():
    """python -m w2rap_contigger_tpu_torch.bench once per sort back end,
    each in its own process."""
    lines = {}
    for sort in BENCH_SORT_KERNELS:
        t0 = time.time()
        res = subprocess.run([sys.executable, "-m", "w2rap_contigger_tpu_torch.bench"],
                             cwd=REPO, env={**os.environ, "W2RAP_SORT": sort},
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"the bench under {sort} exited {res.returncode}: {res.stderr[-2000:]}")
        out = res.stdout.strip().splitlines()
        print(out[-1], flush=True)
        line = lines[sort] = json.loads(out[-1])
        detail = line["detail"]
        launches = detail["launches_per_chain"]
        if (detail["sort_backend"] != sort or not detail["chain_equals_count_kmers_device"]
                or detail["radix_recounts"] != 0):
            fail(f"the bench under {sort}: {detail}")
        if launches.get("kmerize") != BENCH_CHUNKS or launches.get("collapse") != 1:
            fail(f"the bench under {sort}: K1 and K2 launches a chain {launches}")
        if any(launches.get(name, 0) <= 0 for name in BENCH_SORT_KERNELS[sort]):
            fail(f"the bench under {sort}: a sort kernel was not launched {launches}")
        say("bench", sort=sort, seconds=f"{time.time() - t0:.1f}", kmers_per_s=line["value"],
            chain_s=detail["kernel_wall_s"], unique_kmers=detail["unique_kmers"],
            recounts=detail["radix_recounts"], launches=json.dumps(launches))
    digests = {sort: line["detail"]["dict_sha256"] for sort, line in lines.items()}
    if len(set(digests.values())) != 1:
        fail(f"the bench's dictionaries differ between sort back ends {digests}")
    say("bench_identical", lax_vs_radix=True, lax_vs_pallas=True)


def check_banded_costs():
    """ops.align.banded_costs_batch on the card against the CPU, at the
    batch of a friend-alignment stack: 256 pairs of 250 bases, ragged
    lengths, bandwidth 16."""
    rng = np.random.default_rng(SEED)
    B, L, bw = 256, READ_LEN, 16
    Ts = rng.integers(0, 4, (B, L)).astype(np.int8)
    Ss = Ts.copy()
    Ss[rng.random((B, L)) < 0.02] = 0
    lens_s = rng.integers(L - 40, L + 1, B).astype(np.int32)
    lens_t = rng.integers(L - 20, L + 1, B).astype(np.int32)
    got, first_ms = once_ms(lambda: align.banded_costs_batch(Ss, Ts, lens_s, lens_t, 0, bw))
    t0 = time.time()
    want = align.banded_costs_batch(Ss, Ts, lens_s, lens_t, 0, bw, device="cpu")
    cpu_s = time.time() - t0
    if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
        fail("banded_costs_batch: cuda and cpu differ")
    ms = time_ms(lambda: align.banded_costs_batch(Ss, Ts, lens_s, lens_t, 0, bw))
    say("banded_costs", B=B, Ls=L, Lt=L, bandwidth=bw, cuda_first_ms=f"{first_ms:.2f}",
        cuda_ms=f"{ms:.2f}", cpu_s=f"{cpu_s:.3f}", reachable=int((want < int(align.BIG)).sum()),
        identical=True)


# ---------------------------------------------------------------------------
# the JAX package's outputs at E. coli scale, by sha256
# ---------------------------------------------------------------------------

# scripts/port_parity.sh ecoli ecoli_gaps (the JAX package on the CPU,
# --dump_all; scripts/output_hashes.py: an npz array over its dtype,
# shape and bytes, any other file over its bytes)
EXPECTED = {
    "ecoli": {
        "a.fin.frags.dist":
            "bf8c79e5da89b994303944281f5fd89fe3397143e45ba7f9490b9c34a24a8da1",
        "a.lines.fasta":
            "806eb8da9dbaacc6dada0a9f9daa7130a325ddfa6747537b40557d880c98c5d5",
        "a_contigs_lines.gfa":
            "d65e133e688623d5491bdfcc9cc29db40efea47d917b12371cd0aebbc342b106",
        "a_contigs_raw.gfa":
            "0f7f77c6bec9df599273716c883ac771de7741ead2317820ed7246a64c9c3c23",
        "frag_reads_orig.npz:bases":
            "2d1bc6c083bf0ef7533f6b166f53fe5439eb3774b41838414f1065d28ba0bd9b",
        "frag_reads_orig.npz:lengths":
            "b700acd4820a8753cd51cf2b9722839242b00b1e0b25af27313f225a254e7c4d",
        "frag_reads_orig.npz:quals":
            "02b5f8900823f16ef7e8115929bc5e0c4e10c46aa68a48bcc281abbe5071ab4f",
        "pe.contig.hbv.npz:edge_bases":
            "21de61ee0c9400f391944dbe0238ca42fc583740a7b357fb97a0ce292939e8e3",
        "pe.contig.hbv.npz:edge_start":
            "1cdc365650f347a15a45f914d11afe4bafde03fd3cf634a1420df6a025f5c959",
        "pe.contig.hbv.npz:inv":
            "d4ce76f01cf8d32e63a6ebdc73e8bdd51c6f4cc9999e7f06705c56375b525675",
        "pe.contig.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.contig.hbv.npz:n_vertices":
            "cf05341c2ac4e559ed81238b4b6ca470f1e9e8d7be60d624e85ecd64ff3ab300",
        "pe.contig.hbv.npz:to_left":
            "f2e9df7c7fa5a71099ed1287e6638c86962f1427608c4dc934cc6d78ac0a5c75",
        "pe.contig.hbv.npz:to_right":
            "5278030b3b97f57aa119c137684a93403d7357773a6c329232a03ed023f87d51",
        "pe.contig.paths.npz:edges":
            "abe1b3b8d1592e1fa977c949b6cbfb18fc742ee221ae6ab1361ac2b7eef807a5",
        "pe.contig.paths.npz:offsets":
            "409db5678f47173d3be6dedd49b75de981a08dfac661919f103617eccc36b281",
        "pe.contig.paths.npz:start":
            "5c5e0e7fda2026838e6cba5b888dda31f4cf3a434337cb3385df93b35089f582",
        "pe.large_K.clean.hbv.npz:edge_bases":
            "21de61ee0c9400f391944dbe0238ca42fc583740a7b357fb97a0ce292939e8e3",
        "pe.large_K.clean.hbv.npz:edge_start":
            "1cdc365650f347a15a45f914d11afe4bafde03fd3cf634a1420df6a025f5c959",
        "pe.large_K.clean.hbv.npz:inv":
            "d4ce76f01cf8d32e63a6ebdc73e8bdd51c6f4cc9999e7f06705c56375b525675",
        "pe.large_K.clean.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.clean.hbv.npz:n_vertices":
            "cf05341c2ac4e559ed81238b4b6ca470f1e9e8d7be60d624e85ecd64ff3ab300",
        "pe.large_K.clean.hbv.npz:to_left":
            "f2e9df7c7fa5a71099ed1287e6638c86962f1427608c4dc934cc6d78ac0a5c75",
        "pe.large_K.clean.hbv.npz:to_right":
            "5278030b3b97f57aa119c137684a93403d7357773a6c329232a03ed023f87d51",
        "pe.large_K.clean.paths.npz:edges":
            "d160ce90e75c5ff6fe6c56394fc5ffd7ea04d6fa5d6b40d4c475d199d12c91dc",
        "pe.large_K.clean.paths.npz:offsets":
            "3e3efec063b8ebe268b62aec176c2bdc1e9023d6d5137886ad313bc74879cb53",
        "pe.large_K.clean.paths.npz:start":
            "d6842b86aee3b438730812e425695bcfd8fc43c144d03cb5b9ce4c2259857b08",
        "pe.large_K.final.hbv.npz:edge_bases":
            "21de61ee0c9400f391944dbe0238ca42fc583740a7b357fb97a0ce292939e8e3",
        "pe.large_K.final.hbv.npz:edge_start":
            "1cdc365650f347a15a45f914d11afe4bafde03fd3cf634a1420df6a025f5c959",
        "pe.large_K.final.hbv.npz:inv":
            "d4ce76f01cf8d32e63a6ebdc73e8bdd51c6f4cc9999e7f06705c56375b525675",
        "pe.large_K.final.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.final.hbv.npz:n_vertices":
            "cf05341c2ac4e559ed81238b4b6ca470f1e9e8d7be60d624e85ecd64ff3ab300",
        "pe.large_K.final.hbv.npz:to_left":
            "f2e9df7c7fa5a71099ed1287e6638c86962f1427608c4dc934cc6d78ac0a5c75",
        "pe.large_K.final.hbv.npz:to_right":
            "5278030b3b97f57aa119c137684a93403d7357773a6c329232a03ed023f87d51",
        "pe.large_K.final.paths.npz:edges":
            "d160ce90e75c5ff6fe6c56394fc5ffd7ea04d6fa5d6b40d4c475d199d12c91dc",
        "pe.large_K.final.paths.npz:offsets":
            "3e3efec063b8ebe268b62aec176c2bdc1e9023d6d5137886ad313bc74879cb53",
        "pe.large_K.final.paths.npz:start":
            "d6842b86aee3b438730812e425695bcfd8fc43c144d03cb5b9ce4c2259857b08",
        "pe.large_K.hbv.npz:edge_bases":
            "21de61ee0c9400f391944dbe0238ca42fc583740a7b357fb97a0ce292939e8e3",
        "pe.large_K.hbv.npz:edge_start":
            "1cdc365650f347a15a45f914d11afe4bafde03fd3cf634a1420df6a025f5c959",
        "pe.large_K.hbv.npz:inv":
            "d4ce76f01cf8d32e63a6ebdc73e8bdd51c6f4cc9999e7f06705c56375b525675",
        "pe.large_K.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.hbv.npz:n_vertices":
            "cf05341c2ac4e559ed81238b4b6ca470f1e9e8d7be60d624e85ecd64ff3ab300",
        "pe.large_K.hbv.npz:to_left":
            "f2e9df7c7fa5a71099ed1287e6638c86962f1427608c4dc934cc6d78ac0a5c75",
        "pe.large_K.hbv.npz:to_right":
            "5278030b3b97f57aa119c137684a93403d7357773a6c329232a03ed023f87d51",
        "pe.large_K.paths.npz:edges":
            "d160ce90e75c5ff6fe6c56394fc5ffd7ea04d6fa5d6b40d4c475d199d12c91dc",
        "pe.large_K.paths.npz:offsets":
            "3e3efec063b8ebe268b62aec176c2bdc1e9023d6d5137886ad313bc74879cb53",
        "pe.large_K.paths.npz:start":
            "d6842b86aee3b438730812e425695bcfd8fc43c144d03cb5b9ce4c2259857b08",
        "pe.small_K.hbv.npz:edge_bases":
            "fc090689c999f17423aac0363cb12bb8fd1ffc76182055383e7535a57360b223",
        "pe.small_K.hbv.npz:edge_start":
            "0883958a9bd02fba6b98731d025d61fa6877e2a7fb2fe8a896c93fcd0ec01a52",
        "pe.small_K.hbv.npz:inv":
            "c053937e972fea4be5b255e139068b5c5f2c981916278de97c7fe16aa464b71c",
        "pe.small_K.hbv.npz:k":
            "aeebadd34227b791aad43e9910129675389d04e8f82927b3656ce5a31ae3ab13",
        "pe.small_K.hbv.npz:n_vertices":
            "6ce5f48251e927890fee1eb231162fabfba8a5e0ddc809060aa1d5e95ce484e9",
        "pe.small_K.hbv.npz:to_left":
            "fa98468224b258c8587563038d295e32f6f3cc74d1e40f42d9149ecfae1b3ae5",
        "pe.small_K.hbv.npz:to_right":
            "678c3f7caf05a22edce9b3a42a06afbb9fc90ab4b59a25ee6a24c01083f94442",
        "pe.small_K.paths.npz:edges":
            "a9580d709fa5840b275d9c3285a58272e34dc3b9a55f1cd73d78fa48913dc464",
        "pe.small_K.paths.npz:offsets":
            "3e3efec063b8ebe268b62aec176c2bdc1e9023d6d5137886ad313bc74879cb53",
        "pe.small_K.paths.npz:start":
            "d6842b86aee3b438730812e425695bcfd8fc43c144d03cb5b9ce4c2259857b08",
        "pe_assembly_lines.gfa":
            "d65e133e688623d5491bdfcc9cc29db40efea47d917b12371cd0aebbc342b106",
        "pe_assembly_raw.gfa":
            "0f7f77c6bec9df599273716c883ac771de7741ead2317820ed7246a64c9c3c23",
        "reads/reads_R1.fastq":
            "9e4e34ebf41ee6354ca8dc995d47985acbf196311c045536e8ea00c9fd115087",
        "reads/reads_R2.fastq":
            "0ca7e061b37e4a7ecd8647317afdb588bb8af8f751c4d9e4a58653d9aeeb70f0",
        "small_K.freqs":
            "d7d31960de14060a465ee11a9807e0f162d455598773e127ef05c1a553736e36",
        "stats":
            "3872d1f588704760169b77d0f353bfab35c99e038dea35efc2b4edeee3223745",
    },
    "ecoli_gaps": {
        "a.fin.frags.dist":
            "bf8c79e5da89b994303944281f5fd89fe3397143e45ba7f9490b9c34a24a8da1",
        "a.lines.fasta":
            "3d301702d8d7d39d55702e1b11007d11f5914e57ebb09d8490be8f47d3209333",
        "a_contigs_lines.gfa":
            "9b89cbc883c1d8b4bffa349f2def3db4a07aa7ca5c1261f88ffa90c13ac8978c",
        "a_contigs_raw.gfa":
            "d9fd9b2d297eda37aa2d4ea456735c1af521d258b89f4eb49a75297b1d8a8057",
        "frag_reads_orig.npz:bases":
            "aaf4e773cb1b05c1b4b50c5fb2e3fd7757c52fc6439a94b0fe9e8b76e617b504",
        "frag_reads_orig.npz:lengths":
            "b700acd4820a8753cd51cf2b9722839242b00b1e0b25af27313f225a254e7c4d",
        "frag_reads_orig.npz:quals":
            "43b64786d0ee35111bfe18234832a1d25485ff7ab465e058a6f4ee6f57e0aff3",
        "pe.contig.hbv.npz:edge_bases":
            "d6e001b7abe8d5e7883a7b0f87c0c940389edecda411c8bd6aff31a7bd6e72ad",
        "pe.contig.hbv.npz:edge_start":
            "c16e587b3ae4daf87a0f045722d759b602ad76be24b7e31e08151b38d3418b49",
        "pe.contig.hbv.npz:inv":
            "a778911d80815711e60ee12986f59edf74b93eff535951876b7f13bb81949d7a",
        "pe.contig.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.contig.hbv.npz:n_vertices":
            "014dca5eecbc3c30d1827c824abfa2360ab2b1eb7a4e8a1f77280fb0ab24cb9e",
        "pe.contig.hbv.npz:to_left":
            "ccd1976864ca305fd9febd797973690cacdf8ffeace4bf0c743e85fe33119ba0",
        "pe.contig.hbv.npz:to_right":
            "5bf3e8170ff52535686bd54bd61012ad76287230b5c98fc313a8fe9e47451c38",
        "pe.contig.paths.npz:edges":
            "719775238027eaae9d1d77f67c682164752e215dc74566cc4e25b1ccf3b03846",
        "pe.contig.paths.npz:offsets":
            "47b71f6483546591e5343b65fe59f0e196b0e11e2dce23dd63300fc140f0892d",
        "pe.contig.paths.npz:start":
            "222363afc1fdf30354e117a2cede8001b4995a079c49d15c567da40b5b8226c8",
        "pe.large_K.clean.hbv.npz:edge_bases":
            "ad847a0cc62858c65e6e4d03a305552b4dd654ece4ac729f0366b85a198f174b",
        "pe.large_K.clean.hbv.npz:edge_start":
            "cb9c533b1114290969e80eff3705a444b3c5c2a56d3b0d83f7c15d0e9d86c026",
        "pe.large_K.clean.hbv.npz:inv":
            "1b3d76af39fa0bcd6777aea9f6443c5d9b96d662d56b4a042c7ef8fa63855566",
        "pe.large_K.clean.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.clean.hbv.npz:n_vertices":
            "405705fcc7188fdd7e86f769ff20b4bf4aa76fd7d0a8095e3461545d3acf301a",
        "pe.large_K.clean.hbv.npz:to_left":
            "1cdef5c06f091aec5cfafc6ef09fff1c4201f0e94cad6f8e814a49dc1db92ecb",
        "pe.large_K.clean.hbv.npz:to_right":
            "4b004a008151080f3a87df8842e6d047e2b750f3172acb741a7f244497cf69ab",
        "pe.large_K.clean.paths.npz:edges":
            "08492f5cb03e5ab49ea027ed679ca0ddfa13721df8547edef6edc45576fc948d",
        "pe.large_K.clean.paths.npz:offsets":
            "d148c02792906654a3106da41fb5e5aa9fedef4257e635f2b9b135ca4d186256",
        "pe.large_K.clean.paths.npz:start":
            "2b74a16b7d40afce7c5ba7f44e09ee4c89aec3d8b08237daca7f3cba4e7bc658",
        "pe.large_K.final.hbv.npz:edge_bases":
            "4815141edfee822df3b7d58db858b28f8d61d2cdb6fb6ec0337ef715ff23c14c",
        "pe.large_K.final.hbv.npz:edge_start":
            "e63451bcf9ee5f35d413a16a34743c6286afe738dd77d778fc958a49f9ee3140",
        "pe.large_K.final.hbv.npz:inv":
            "a26e7aecafd55d896f04a889e9c041683b81ee2fd8b390442ea0a91b2541a331",
        "pe.large_K.final.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.final.hbv.npz:n_vertices":
            "6dd6bf3795f039ea7105ea2199d961c2d5f3463e026aba5dd89515bea8ee45cd",
        "pe.large_K.final.hbv.npz:to_left":
            "6d3b1e20a9d7cfc0cc7f84d9643a2e9c8c843d6cee49aa6ce491b4d0083405c4",
        "pe.large_K.final.hbv.npz:to_right":
            "59e06faac0a5d849803f497404f08255c10d727ec6e66aea8a0c047c76317c59",
        "pe.large_K.final.paths.npz:edges":
            "388c444cf34ff7310f386954349d62df55e082994ef1a68e5d0c7e7ce9b75f9f",
        "pe.large_K.final.paths.npz:offsets":
            "61671c2c8d0431b5ecfaf643057306bc96f49fe96126d9f35be069245171334f",
        "pe.large_K.final.paths.npz:start":
            "b13e425ad6b6f32bb40c04c2a5e777a5154b9db3db7091477e96d4fb7e67d76b",
        "pe.large_K.hbv.npz:edge_bases":
            "561646a0278e4477145b9eb9aa1fb7cb3ed2b107de285683c157e4c68c84b6b1",
        "pe.large_K.hbv.npz:edge_start":
            "087dee984fe5c8c6533935f4be038a5946391c1da063109759096b04a0ea801d",
        "pe.large_K.hbv.npz:inv":
            "62db9ee1c80b34495e43c456901ce681ed20633002f9f954ca6912f75d52b2d2",
        "pe.large_K.hbv.npz:k":
            "4d1c5f604c1c488ceeb102832873f295bba6f540a3eb926eee66f6ad3e5e289d",
        "pe.large_K.hbv.npz:n_vertices":
            "aa7ddfd433a3cdb7472fd80d919fa997d652428434b52466020e21f81c2f794c",
        "pe.large_K.hbv.npz:to_left":
            "21c2e25157bb5016b54b1a9ae3dd94ad89f1acd992ed2480f326469c58f244ef",
        "pe.large_K.hbv.npz:to_right":
            "30695ddc396d6f218922adfc3834fb8bc6102ed828057105bf3eda7b429f97b2",
        "pe.large_K.paths.npz:edges":
            "48e91c996e03339c4733383306163742d7962364f32f7cbc2cad25050db87a1e",
        "pe.large_K.paths.npz:offsets":
            "3696fa2f8a3db9c0ae568d1f796c821eb54993080387abaa1b884dfcc2e4155d",
        "pe.large_K.paths.npz:start":
            "5fa3c53e30655dd5dd0a5543f5c50ada9b420d499f08b1173080e88018218b1e",
        "pe.small_K.hbv.npz:edge_bases":
            "e53793bcc0ebb0a480ace9eab69403dbdaf6793b69b90b7cd9e0e4b2b1450a46",
        "pe.small_K.hbv.npz:edge_start":
            "a1a65a6da3ff4f80174cf7bf8c5e5ce57a6918ce99af31c487811ae4daee993b",
        "pe.small_K.hbv.npz:inv":
            "9a8783d55ebcd672c05f4d7d131f5831e8bc1ce3e55ad5422ef1da6490efe260",
        "pe.small_K.hbv.npz:k":
            "aeebadd34227b791aad43e9910129675389d04e8f82927b3656ce5a31ae3ab13",
        "pe.small_K.hbv.npz:n_vertices":
            "a4a0a8863ceacf4dad864037e42665a81800f262556f1119446cc3665c87413a",
        "pe.small_K.hbv.npz:to_left":
            "44fe94712d2a5788cae73ba99de94ebc4861b8715fa5cbda47a1f28f208471a4",
        "pe.small_K.hbv.npz:to_right":
            "8e5c26c945aad4f79146a0703e293ae75dee4aaff60093d93c7d865194c8e5f8",
        "pe.small_K.paths.npz:edges":
            "e8a7b1551a786d776e33ad3892aa690dc4acce66da53540d9431ad67535538d0",
        "pe.small_K.paths.npz:offsets":
            "73bb03e0f8b6581072b0564ebf53d780711ab23b858916c0bf255dd2aac04148",
        "pe.small_K.paths.npz:start":
            "14ac4e20bf21174c6e1bfb0375a6d800fd6be0393e1900ad3020475c6d7ae371",
        "pe_assembly_lines.gfa":
            "9b89cbc883c1d8b4bffa349f2def3db4a07aa7ca5c1261f88ffa90c13ac8978c",
        "pe_assembly_raw.gfa":
            "d9fd9b2d297eda37aa2d4ea456735c1af521d258b89f4eb49a75297b1d8a8057",
        "reads/reads_R1.fastq":
            "a37314ac0874e401e2c9a27428f55bb761a5dbd136727a26ccbe7986fa0d1c4e",
        "reads/reads_R2.fastq":
            "bcb56c7d341ccd7fa4ff2891f68041c2aa1ba7e806359ec2a197a466c3042451",
        "small_K.freqs":
            "097da23b8e25ef74ce8786788bec9d35d1fa2718dea8676313e72adfea84e13d",
        "stats":
            "9a4050a624a87789274090aed6544224ebf4d388038e7395519f28b361cd4318",
    },
}


def check_hashes(label: str, config: str, data: str, out: str, names) -> int:
    """The reads of `data` and the files `names` of `out` against
    EXPECTED[config] (every key of those files); returns the count."""
    want = {key: h for key, h in EXPECTED[config].items()
            if key.startswith("reads/") or key.split(":")[0] in names}
    got = {**reads_hashes(data), **output_hashes(out, names)}
    diffs = sorted(key for key in set(want) | set(got) if want.get(key) != got.get(key))
    if diffs:
        fail(f"{label}: outputs differ from the JAX package's in {diffs}")
    return len(want)


# ---------------------------------------------------------------------------
# phases 4-6: the port's steps through its CLI entry
# ---------------------------------------------------------------------------


def synth(out_dir: str, glen: int, pairs: int, seed: int = SEED, extra=()):
    t0 = time.time()
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         out_dir, "--glen", str(glen), "--pairs", str(pairs),
         "--rlen", str(READ_LEN), "--insert", "500", "--seed", str(seed), *extra],
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


def same_files(a: str, b: str, names) -> list[str]:
    """Every array of the npz files and every other file byte for byte;
    a file present in one directory only differs."""
    diffs = []
    for name in names:
        there = [os.path.exists(f"{d}/{name}") for d in (a, b)]
        if not all(there):
            if any(there):
                diffs.append(f"{name}: in one run only")
            continue
        if name.endswith(".npz"):
            za, zb = np.load(f"{a}/{name}"), np.load(f"{b}/{name}")
            if sorted(za.files) != sorted(zb.files) or any(
                    za[key].shape != zb[key].shape or not np.array_equal(za[key], zb[key])
                    for key in za.files):
                diffs.append(name)
            continue
        with open(f"{a}/{name}", "rb") as fa, open(f"{b}/{name}", "rb") as fb:
            if fa.read() != fb.read():
                diffs.append(name)
    return diffs


def contig_stats(out_dir: str) -> dict:
    """The line count and N50 of `stats`, and the records of a.lines.fasta."""
    with open(f"{out_dir}/stats") as f:
        stats = dict(line.strip().split(": ", 1) for line in f if ": " in line)
    with open(f"{out_dir}/a.lines.fasta") as f:
        records = sum(line.startswith(">") for line in f)
    return {"n_lines": int(stats["n_lines"]), "contig_line_N50": int(stats["contig_line_N50"]),
            "fasta_records": records, "cn_frac_good": stats["cn_frac_good"]}


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


class Step5Watch:
    """Wraps step 5 for one run: the blob counts of assemble_gaps2 and
    the kernel launches inside add_new_stuff (the step's device work)."""

    def __init__(self):
        self.stats = {"blobs": 0, "solved": 0, "pieces": 0}
        self.launches = {n: 0 for n in tdev.LAUNCHES}

    def __enter__(self):
        self._ag2, self._ans = step5_gaps.assemble_gaps2, step5_gaps.add_new_stuff

        def ag2(*a, **kw):
            return self._ag2(*a, stats=self.stats, **kw)

        def ans(*a, **kw):
            before = dict(tdev.LAUNCHES)
            out = self._ans(*a, **kw)
            self.launches = {n: tdev.LAUNCHES[n] - before[n] for n in before}
            return out

        step5_gaps.assemble_gaps2, step5_gaps.add_new_stuff = ag2, ans
        return self

    def __exit__(self, *exc):
        step5_gaps.assemble_gaps2, step5_gaps.add_new_stuff = self._ag2, self._ans


class Step67Watch:
    """Wraps steps 6-7 for one run: the kernel launches from the start of
    Simplify to the end of the run, the edges Simplify was given and the
    gaps MakeGaps added."""

    def __init__(self):
        self.before = None
        self.edges_in = self.n_gaps = 0

    def __enter__(self):
        self._simplify, self._make_gaps = step6_simplify.simplify, step7_scaffold.make_gaps

        def simplify(hbv, *a, **kw):
            self.before = dict(tdev.LAUNCHES)
            self.edges_in = hbv.n_edges
            return self._simplify(hbv, *a, **kw)

        def make_gaps(*a, **kw):
            hbv, paths, n_gaps = self._make_gaps(*a, **kw)
            self.n_gaps = n_gaps
            return hbv, paths, n_gaps

        step6_simplify.simplify, step7_scaffold.make_gaps = simplify, make_gaps
        return self

    def __exit__(self, *exc):
        step6_simplify.simplify, step7_scaffold.make_gaps = self._simplify, self._make_gaps

    def launches(self) -> dict:
        """Launches since Simplify began, by kernel (all zero)."""
        if self.before is None:
            fail("step 6 did not run")
        return {n: tdev.LAUNCHES[n] - self.before[n] for n in self.before}


def phase_parity_step5(work: str):
    """Steps 1-7 at K=200 on the repeat-rich 500 kb genome, cuda against
    cpu under the default sort: every checkpoint and every step 6-7 file
    identical, a blob solved, a piece added, K2 launched inside step 5
    and nothing in steps 6-7."""
    data = f"{work}/rep500"
    gen_s = synth(data, REPEAT["glen"], REPEAT["pairs"], REPEAT["seed"], REPEAT["extra"])
    times, stats, splits = {}, {}, {}
    os.environ["W2RAP_TIMELOG"] = "1"
    for dev in (DEV, "cpu"):
        sysinfo.timelog_reset()
        tdev.reset_launches()
        t0 = time.time()
        with Step5Watch() as watch, Step67Watch() as watch67:
            run_cli(data, f"{data}/{dev}", dev,
                    ["-K", "200", "--dump_all", "--dump_perf"], to_step=7)
        times[dev] = time.time() - t0
        stats[dev] = dict(watch.stats, gaps=watch67.n_gaps)
        splits[dev] = {k: v for k, v in _split().items() if k.startswith(("step5", "step6",
                                                                          "step7"))}
        if dev == DEV:
            step5_launches = watch.launches
            step67_launches = watch67.launches()
    diffs = same_outputs(f"{data}/{DEV}", f"{data}/cpu", SMALL_K + LARGE_K + CLEAN + FINAL)
    diffs += same_files(f"{data}/{DEV}", f"{data}/cpu", STEP67_FILES + ASSEMBLY)
    if diffs:
        fail(f"repeat-rich 500 kb steps 1-7: cuda and cpu outputs differ in {diffs}")
    if any(step67_launches.values()):
        fail(f"repeat-rich 500 kb: steps 6-7 launched kernels {step67_launches}")
    if stats[DEV] != stats["cpu"]:
        fail(f"repeat-rich 500 kb: blob counts differ {stats}")
    if stats[DEV]["solved"] <= 0 or stats[DEV]["pieces"] <= 0:
        fail(f"repeat-rich 500 kb: step 5 solved no blob or added no piece {stats[DEV]}")
    if step5_launches["collapse"] <= 0:
        fail(f"repeat-rich 500 kb: K2 was not launched in step 5 {step5_launches}")
    edges = [len(np.load(f"{data}/{DEV}/{name}")["inv"])
             for name in (CLEAN[0], FINAL[0], CONTIG[0])]
    say("parity_500kb_steps1_7", K=200, sort="lax", synth_s=f"{gen_s:.1f}",
        cuda_s=f"{times[DEV]:.2f}", cpu_s=f"{times['cpu']:.2f}",
        blobs=stats[DEV]["blobs"], solved=stats[DEV]["solved"], pieces=stats[DEV]["pieces"],
        edges_clean=edges[0], edges_final=edges[1], edges_contig=edges[2],
        gaps=stats[DEV]["gaps"],
        assemble_gaps_cuda_s=_perf_seconds(f"{data}/{DEV}", "AssembleGaps"),
        assemble_gaps_cpu_s=_perf_seconds(f"{data}/cpu", "AssembleGaps"),
        simplify_cuda_s=_perf_seconds(f"{data}/{DEV}", "Simplify"),
        simplify_cpu_s=_perf_seconds(f"{data}/cpu", "Simplify"),
        make_gaps_final_files_cuda_s=_perf_seconds(f"{data}/{DEV}", "MakeGaps+FinalFiles"),
        make_gaps_final_files_cpu_s=_perf_seconds(f"{data}/cpu", "MakeGaps+FinalFiles"),
        **contig_stats(f"{data}/{DEV}"),
        step5_launches=json.dumps({n: v for n, v in step5_launches.items() if v}),
        step67_launches=sum(step67_launches.values()), identical=True)
    for dev in (DEV, "cpu"):
        say("parity_500kb_split", device=dev, **splits[dev])


def _split() -> dict:
    split = {}
    for line in sysinfo.timelog_report().splitlines():
        _, name, secs, _ = [x.strip() for x in line.split(",")]
        split[name] = secs
    return split


def timelog_calls(span: str) -> int:
    """How many times the timelog saw `span` since its last reset."""
    for line in sysinfo.timelog_report().splitlines():
        _, name, _, calls = [x.strip() for x in line.split(",")]
        if name == span:
            return int(calls.split()[0])
    return 0


class CountPeak:
    """Wraps step 2's count for one run: the peak device memory inside it
    (the peak statistics reset as it starts) and its wall."""

    def __enter__(self):
        self._count = tke.count_kmers_batched

        def count(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = self._count(*a, **kw)
            torch.cuda.synchronize()
            self.seconds = time.time() - t0
            self.peak = torch.cuda.max_memory_allocated()
            return out

        tke.count_kmers_batched = count
        return self

    def __exit__(self, *exc):
        tke.count_kmers_batched = self._count


def phase_scale(data: str) -> tuple[dict, int]:
    """Step 2 at E. coli scale; returns its launches and the peak device
    memory of its count."""
    os.environ["W2RAP_TIMELOG"] = "1"
    sysinfo.timelog_reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tdev.reset_launches()
    t0 = time.time()
    with CountPeak() as count:
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
        max_memory_allocated=peak, count_s=f"{count.seconds:.3f}",
        count_max_memory_allocated=count.peak, launches=json.dumps(launches))
    say("ecoli_split", **_split())
    say("ecoli_perf", perf=repr(perf))
    return launches, count.peak


def phase_batched(data: str, launches: dict, count_peak: int):
    """Steps 1-2 at E. coli scale with -d 4 -m 4 --tmp_dir (4 hash ranges
    or more, each spilled) against phase 5's unbatched run: small_K.freqs
    and the small_K checkpoints identical, the spill files gone, the
    count's peak device memory within the 4 GiB ceiling and below the
    unbatched one's, K2 launched once a range and K1 once a range plus
    the pass that sizes the ranges."""
    os.environ["W2RAP_TIMELOG"] = "1"
    sysinfo.timelog_reset()
    tdev.reset_launches()
    spill = f"{data}/spill"
    t0 = time.time()
    with CountPeak() as count:
        run_cli(data, f"{data}/batched", DEV,
                ["-d", "4", "-m", "4", "--tmp_dir", spill, "--dump_perf"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = dict(tdev.LAUNCHES)
    diffs = same_outputs(f"{data}/out", f"{data}/batched")
    if diffs:
        fail(f"E. coli step 2: -d 4 -m 4 and unbatched outputs differ in {diffs}")
    left = os.listdir(spill) if os.path.isdir(spill) else None
    if left != []:
        fail(f"E. coli -d 4 --tmp_dir: the spill directory holds {left}")
    if count.peak >= count_peak or count.peak > 4 << 30:
        fail(f"E. coli -d 4 -m 4: the count's peak device memory {count.peak} is not "
             f"within 4 GiB and below the unbatched {count_peak}")
    split = _split()
    R = timelog_calls("step2.count.sort")
    if R < 4 or (got["collapse"] != R * launches["collapse"]
            or got["kmerize"] != (R + 1) * launches["kmerize"]):
        fail(f"E. coli -d 4: {R} ranges, launches {got} against unbatched {launches}")
    say("ecoli_batched", disk_batches=4, max_mem_gb=4, ranges=R, wall_s=f"{wall:.2f}",
        count_s=f"{count.seconds:.3f}", count_max_memory_allocated=count.peak,
        unbatched_count_max_memory_allocated=count_peak,
        kmerize=got["kmerize"], collapse=got["collapse"],
        unbatched_kmerize=launches["kmerize"], unbatched_collapse=launches["collapse"],
        spill_left=len(left), identical=True)
    say("ecoli_batched_split", **{k: v for k, v in split.items()
                                  if k.startswith("step2.count")})


def phase_fill_join(work: str):
    """Step 2 with --fill_join on scripts/parity_filljoin.sh's low-coverage
    200 kb genome (10k PE250 pairs, seed 11), --device cuda against
    --device cpu: small_K.freqs and the small_K checkpoints identical, and
    different from the card's run without --fill_join."""
    data = f"{work}/fj200"
    gen_s = synth(data, FILL_JOIN["glen"], FILL_JOIN["pairs"], FILL_JOIN["seed"])
    os.environ["W2RAP_TIMELOG"] = "1"
    times = {}
    for label, dev, extra in (("cuda_fj", DEV, ["--fill_join"]), ("cpu_fj", "cpu", ["--fill_join"]),
                              ("cuda", DEV, [])):
        sysinfo.timelog_reset()
        tdev.reset_launches()
        t0 = time.time()
        _, _, d = run_cli(data, f"{data}/{label}", dev, ["-K", "200", *extra])
        times[label] = time.time() - t0
        if label == "cuda_fj":
            launches = {n: v for n, v in tdev.LAUNCHES.items() if v}
            split = {k: v for k, v in _split().items()
                     if k.startswith(("step2.fill_gaps", "step2.join_overlaps"))}
            kmers = d.size
    diffs = same_outputs(f"{data}/cuda_fj", f"{data}/cpu_fj")
    if diffs:
        fail(f"200 kb --fill_join: cuda and cpu outputs differ in {diffs}")
    if not same_outputs(f"{data}/cuda_fj", f"{data}/cuda"):
        fail("200 kb --fill_join: the small-K graph is the same as without it")
    edges = [len(np.load(f"{data}/{x}/{SMALL_K[0]}")["inv"]) for x in ("cuda", "cuda_fj")]
    say("fill_join_200kb", genome=FILL_JOIN["glen"], pairs=FILL_JOIN["pairs"],
        synth_s=f"{gen_s:.1f}", cuda_s=f"{times['cuda_fj']:.2f}",
        cpu_s=f"{times['cpu_fj']:.2f}", cuda_plain_s=f"{times['cuda']:.2f}",
        edges_plain=edges[0], edges_fill_join=edges[1], kmers_fill_join=kmers,
        launches=json.dumps(launches), identical=True, changed=True, **split)


def phase_step4(data: str) -> tuple[dict, int, list, dict]:
    """Steps 1-4 at K=260 under lax, radix, then pallas; returns each
    run's launches, the step-3 stream's row count, the planes step 3
    of the radix run sorted (with num_keys and cmp_keys) and the lax
    run's step2.count and step3.count spans."""
    os.environ["W2RAP_TIMELOG"] = "1"
    rows = {}
    step3_stream = []
    step3 = {}
    orig_count = tke.count_kmers_flat
    orig_repath = step3_repath.repath

    def count_flat(flat, seg, k, *a, **kw):
        rows["k2"] = max(len(flat) - k + 1, 0)
        if os.environ.get("W2RAP_SORT") != "radix":
            return orig_count(flat, seg, k, *a, **kw)
        # the planes step 3's count hands to the partition sort
        orig_sort = radix.partition_sort

        def partition_sort(planes, *pa, **pkw):
            step3_stream[:] = [planes.clone(), pkw["num_keys"], pkw["cmp_keys"]]
            return orig_sort(planes, *pa, **pkw)

        radix.partition_sort = partition_sort
        try:
            return orig_count(flat, seg, k, *a, **kw)
        finally:
            radix.partition_sort = orig_sort

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
            split = _split()
            if sort == "lax":
                counts = {k: split[k] for k in ("step2.count", "step3.count")}
            say("ecoli_k260_split", sort=sort, **{
                k: v for k, v in split.items()
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
    n = check_hashes("E. coli K=260 steps 1-4", "ecoli", data, f"{data}/k260_lax",
                     ("small_K.freqs", "frag_reads_orig.npz") + SMALL_K + LARGE_K + CLEAN)
    say("ecoli_k260_identical", lax_vs_radix=True, lax_vs_pallas=True, jax_hashes=n)
    if not step3_stream:
        fail("step 3 of the radix run did not reach the partition sort")
    return runs, rows["k2"], step3_stream, counts


class MeshWatch:
    """Wraps the sharded functions for one run.  Step 2's and step 3's
    counts (`counts`, by function): each one's stats (the rows each shard
    owns, the rows and bytes exchanged, each owner's device ms of its sort
    and of its K2), host waits, wall and peak device memory (the peak
    statistics reset as it starts).  Every sharded call (both counts,
    adjacencies, links, list ranking, both pathers) runs under torch's
    sync debug mode: an operation that synchronises there is a host wait
    that HOST_WAITS does not see, and lands in `syncs` with its stack."""

    SHARDED = ((tke, "count_kmers_sharded"), (tke, "count_kmers_flat"),
               (gb, "recompute_adjacencies"), (gb, "build_links"), (gb, "list_rank_sharded"),
               (pather, "path_reads"), (flat_pather, "path_flat_sequences"))
    COUNTS = ("count_kmers_sharded", "count_kmers_flat")

    def __enter__(self):
        self.counts, self.syncs, self._orig = {}, [], []
        for mod, name in self.SHARDED:
            self._orig.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self._wrap(name, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)

    def _wrap(self, name, orig):
        def call(*a, **kw):
            if kw.get("mesh") is None and not any(isinstance(x, tmesh.Mesh) for x in a):
                return orig(*a, **kw)
            if name not in self.COUNTS:
                with self._sync_debug(name):
                    return orig(*a, **kw)
            stats = kw["stats"] = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            waits = tdev.HOST_WAITS
            t0 = time.time()
            with self._sync_debug(name):
                out = orig(*a, **kw)
            torch.cuda.synchronize()
            self.counts[name] = dict(stats=stats, seconds=time.time() - t0,
                                     peak=torch.cuda.max_memory_allocated(),
                                     host_waits=tdev.HOST_WAITS - waits)
            return out
        return call

    @contextlib.contextmanager
    def _sync_debug(self, name):
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                # the prefetch workers wait for their own uploads; only the
                # thread that enqueues the shards' work must not wait
                if threading.current_thread() is threading.main_thread():
                    self.syncs.append((name, "".join(traceback.format_stack(limit=8)[:-1])))
            else:
                shown(message, category, filename, lineno, file, line)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")


def run_sharded(data: str, out: str, mesh, K: int, sort: str) -> dict:
    """Steps 1-3 through run_pipeline with an explicit mesh, --dump_all and
    --dump_perf, counts reset just before; fails if a host wait fell
    between two shards' enqueues of a round or a sharded call
    synchronised; returns the launches, the radix recounts, the MeshWatch
    and the wall."""
    os.environ["W2RAP_SORT"] = sort
    sysinfo.timelog_reset()
    tdev.reset_launches()
    tdev.reset_host_waits()
    recounts = tke.RADIX_RECOUNTS
    t0 = time.time()
    try:
        with MeshWatch() as watch, contextlib.redirect_stdout(io.StringIO()) as said:
            hbv, paths, _ = run_pipeline(
                out, read_spec=f"{data}/reads_R1.fastq,{data}/reads_R2.fastq",
                large_k=K, to_step=3, dump_all=True, dump_perf=True, mesh=mesh,
                device=DEV)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("W2RAP_SORT", None)
    if f"sharding over {mesh.size} devices" not in said.getvalue():
        fail(f"the sharded run did not say it shards: {said.getvalue()!r}")
    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    inside = tdev.waits_inside_rounds(tdev.EVENTS)
    if inside:
        fail(f"{out}: a host wait fell between two shards' enqueues: {inside[:4]}")
    if watch.syncs:
        for name, stack in watch.syncs[:3]:
            print(f"[sync] {name}\n{stack}", flush=True)
        fail(f"{out}: {len(watch.syncs)} synchronising operations in sharded calls "
             f"({sorted({name for name, _ in watch.syncs})})")
    if set(watch.counts) != set(MeshWatch.COUNTS):
        fail(f"{out}: the sharded counts did not run: {sorted(watch.counts)}")
    return dict(launches=dict(tdev.LAUNCHES), recounts=tke.RADIX_RECOUNTS - recounts,
                watch=watch, wall=time.time() - t0)


def check_shard_launches(label: str, run: dict, D: int, k1_chunks: int, sort: str):
    """K1 twice a chunk (the sizing pass and the exchange), K2 once an
    owner in each of steps 2 and 3 (every owner holds rows; an exact radix
    recount sorts again before its K2), and the sort back end's kernels."""
    launches = run["launches"]
    rows = run["watch"].counts["count_kmers_sharded"]["stats"]["rows"]
    if min(rows) <= 0:
        fail(f"{label}: a shard owns no row {rows}")
    want_k2 = 2 * D
    if launches["kmerize"] != 2 * k1_chunks or launches["collapse"] != want_k2:
        fail(f"{label}: K1 {launches['kmerize']} (want {2 * k1_chunks}), "
             f"K2 {launches['collapse']} (want {want_k2})")
    for name in {"radix": K4, "pallas": K3}.get(sort, ()):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was not launched")


def shard_chunks(n_reads: int, D: int) -> int:
    """K1 chunks of a sharded step-2 count: each shard's reads in chunks
    of CHUNK_READS."""
    per = -(-n_reads // D)
    return sum(-(-max(0, min(per, n_reads - s * per)) // CHUNK_READS) for s in range(D))


def phase_mesh(s200: str, data: str, count_peak: int, unsharded: dict):
    """Steps 1-3 over 4 logical shards of the card: 200 kb at K=200 under
    each sort against the unsharded lax run, then E. coli scale at K=260
    (lax) against phase 6's lax run, whose step2.count and step3.count
    spans are `unsharded`; with two cards or more, E. coli again through
    --shard over the real cards."""
    D = 4
    mesh = tmesh.make_mesh([DEV] * D)
    os.environ["W2RAP_TIMELOG"] = "1"
    run_cli(s200, f"{s200}/k200", DEV, ["-K", "200", "--dump_all"], to_step=3)
    n200 = 2 * SMALL["pairs"]
    for sort in ("lax", "radix", "pallas"):
        out = f"{s200}/mesh_{sort}"
        run = run_sharded(s200, out, mesh, 200, sort)
        check_shard_launches(f"200 kb mesh ({sort})", run, D, shard_chunks(n200, D), sort)
        diffs = same_outputs(f"{s200}/k200", out, SMALL_K + LARGE_K)
        if diffs:
            fail(f"200 kb steps 1-3: {D} shards ({sort}) and unsharded differ in {diffs}")
        count = run["watch"].counts["count_kmers_sharded"]
        stats = count["stats"]
        say("mesh_200kb", shards=D, sort=sort, K=200, wall_s=f"{run['wall']:.2f}",
            count_s=f"{count['seconds']:.3f}", rows_max=max(stats["rows"]),
            rows_mean=f"{sum(stats['rows']) / D:.1f}", exchanged_bytes=stats["exchanged_bytes"],
            kmerize=run["launches"]["kmerize"], collapse=run["launches"]["collapse"],
            recounts=run["recounts"], host_waits=tdev.HOST_WAITS,
            launches=json.dumps({n: v for n, v in run["launches"].items() if v}),
            identical=True)
    out = f"{data}/mesh_k260"
    run = run_sharded(data, out, mesh, 260, "lax")
    check_shard_launches("E. coli mesh", run, D, shard_chunks(2 * ECOLI["pairs"], D), "lax")
    diffs = same_outputs(f"{data}/k260_lax", out, SMALL_K + LARGE_K)
    if diffs:
        fail(f"E. coli K=260 steps 1-3: {D} shards and phase 6's lax run differ in {diffs}")
    split = _split()
    step2, step3 = (run["watch"].counts[name] for name in MeshWatch.COUNTS)
    stats = step2["stats"]
    say("mesh_ecoli", shards=D, sort="lax", K=260, wall_s=f"{run['wall']:.2f}",
        rows_max=max(stats["rows"]), rows_mean=f"{sum(stats['rows']) / D:.1f}",
        exchanged_rows=stats["exchanged_rows"], exchanged_bytes=stats["exchanged_bytes"],
        kmerize=run["launches"]["kmerize"], collapse=run["launches"]["collapse"],
        count_s=f"{step2['seconds']:.3f}", count_max_memory_allocated=step2["peak"],
        unsharded_count_max_memory_allocated=count_peak,
        small_k_graph_s=_perf_seconds(out, "SmallKGraph"),
        repath_in_memory_s=_perf_seconds(out, "RepathInMemory"), identical=True)
    say("mesh_ecoli_split", **{k: v for k, v in split.items()
                               if k.startswith(("step2.count", "step3.count"))})
    # sharded beside unsharded (phase 6's lax run), and each owner's
    # device ms of its sort and its K2 (CUDA events on its stream)
    say("mesh_ecoli_counts", step2_count_s=split["step2.count"],
        unsharded_step2_count_s=unsharded["step2.count"], step3_count_s=split["step3.count"],
        unsharded_step3_count_s=unsharded["step3.count"],
        step2_host_waits=step2["host_waits"], step3_host_waits=step3["host_waits"],
        run_host_waits=tdev.HOST_WAITS, step3_count_max_memory_allocated=step3["peak"],
        step2_owner_ms=json.dumps(stats["owner_ms"]),
        step3_owner_ms=json.dumps(step3["stats"]["owner_ms"]), sync_ops=0,
        waits_inside_rounds=0)
    cards = torch.cuda.device_count()
    if cards < 2:
        say("mesh_real_cards", real_cards=cards, skipped=True)
        return
    n = 1 << (cards.bit_length() - 1)
    t0 = time.time()
    tdev.reset_launches()
    run_cli(data, f"{data}/shard_cards", DEV, ["-K", "260", "--dump_all", "--shard", str(n)],
            to_step=3)
    diffs = same_outputs(f"{data}/k260_lax", f"{data}/shard_cards", SMALL_K + LARGE_K)
    if diffs:
        fail(f"E. coli --shard {n} over real cards: outputs differ in {diffs}")
    say("mesh_real_cards", real_cards=cards, shards=n, wall_s=f"{time.time() - t0:.2f}",
        kmerize=tdev.LAUNCHES["kmerize"], collapse=tdev.LAUNCHES["collapse"], identical=True)


def phase_ecoli_gaps(work: str) -> dict:
    """Steps 1-7 at E. coli scale with gaps, K=260, on the card, then
    hbv2gfa on pe.contig; returns the launches of the whole run."""
    data = f"{work}/ecoli_gaps"
    gen_s = synth(data, ECOLI_GAPS["glen"], ECOLI_GAPS["pairs"], ECOLI_GAPS["seed"],
                  ECOLI_GAPS["extra"])
    os.environ["W2RAP_TIMELOG"] = "1"
    sysinfo.timelog_reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tdev.reset_launches()
    t0 = time.time()
    with Step5Watch() as watch, Step67Watch() as watch67:
        hbv, paths, _ = run_cli(data, f"{data}/out", DEV,
                                ["-K", "260", "--dump_perf"], to_step=7)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(tdev.LAUNCHES)
    step67_launches = watch67.launches()
    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    if watch.stats["pieces"] > 0 and watch.launches["collapse"] <= 0:
        fail(f"E. coli with gaps: step 5 added pieces but launched no K2 {watch.launches}")
    if any(step67_launches.values()):
        fail(f"E. coli with gaps: steps 6-7 launched kernels {step67_launches}")
    out = f"{data}/out"
    missing = [n for n in STEP67_FILES if not os.path.exists(f"{out}/{n}")]
    if missing:
        fail(f"E. coli with gaps: steps 6-7 did not write {missing}")
    n_hashes = check_hashes("E. coli with gaps, steps 1-7", "ecoli_gaps", data, out,
                            ("small_K.freqs", "frag_reads_orig.npz") + STEP67_FILES
                            + ASSEMBLY)
    with open(f"{out}/pe.perf") as f:
        perf = " | ".join(x.strip() for x in f)
    say("ecoli_gaps_steps1_7", genome=ECOLI_GAPS["glen"], pairs=ECOLI_GAPS["pairs"], K=260,
        synth_s=f"{gen_s:.1f}", wall_s=f"{wall:.2f}", edges=hbv.n_edges,
        path_edges=len(paths.edges), **watch.stats,
        edges_final=watch67.edges_in,
        edges_contig=len(np.load(f"{out}/{CONTIG[0]}")["inv"]), gaps=watch67.n_gaps,
        **contig_stats(out),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=json.dumps({n: v for n, v in launches.items() if v}),
        step5_launches=json.dumps({n: v for n, v in watch.launches.items() if v}),
        step67_launches=sum(step67_launches.values()), jax_hashes=n_hashes)
    split = _split()
    say("ecoli_gaps_split", **{k: v for k, v in split.items() if k.startswith("step5")})
    say("ecoli_gaps_split67", **{k: v for k, v in split.items()
                                 if k.startswith(("step6", "step7"))})
    say("ecoli_gaps_perf", perf=repr(perf))
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        hbv2gfa.main(["-i", f"{out}/pe.contig", "-o", f"{out}/hbv2gfa",
                      "-g", str(ECOLI_GAPS["glen"] // 1000)])
    gfa_s = time.time() - t0
    stats = dict(line.split(": ", 1) for line in buf.getvalue().splitlines() if ": " in line)
    if not os.path.exists(f"{out}/hbv2gfa_raw.gfa") or "N50" not in stats:
        fail(f"hbv2gfa on pe.contig wrote no GFA or no N50: {buf.getvalue()!r}")
    say("ecoli_gaps_hbv2gfa", seconds=f"{gfa_s:.2f}",
        **{k.replace(" ", "_"): v for k, v in stats.items()})
    return launches


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
    check_kmerize_small()
    k2 = check_collapse(4, STEP2_ROWS, min_count=4)
    check_collapse(13, COLLAPSE_ROWS, min_count=1)
    check_collapse(17, COLLAPSE_ROWS, min_count=1, regions=16)
    check_collapse(4, COLLAPSE_ROWS, min_count=4, one_ctx=True)
    say("collapse_attrs", **kcol.collapse_attrs())
    say("phase3", seconds=f"{time.time() - t0:.1f}")

    # 3b (a): step 2's shape, 4 key words + payload (the radix stream
    # keeps ctx out of the comparator words)
    t0 = time.time()
    check_radix_tiles()
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

    # 3d: the port's benchmark under each sort, banded_costs_batch
    t0 = time.time()
    phase_bench()
    check_banded_costs()
    say("phase3d", seconds=f"{time.time() - t0:.1f}")

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
        phase_parity_step5(work)
        say("phase4c", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        phase_fill_join(work)
        say("phase4d", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        data = f"{work}/ecoli"
        say("synth_ecoli", seconds=f"{synth(data, **ECOLI):.1f}")
        launches, count_peak = phase_scale(data)
        say("phase5", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        phase_batched(data, launches, count_peak)
        say("phase5b", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        runs, k2_rows, step3_stream, counts = phase_step4(data)
        say("phase6", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        phase_mesh(s200, data, count_peak, counts)
        say("phase5c", seconds=f"{time.time() - t0:.1f}")
        t0 = time.time()
        phase_ecoli_gaps(work)
        say("phase7", seconds=f"{time.time() - t0:.1f}")

    # 3b (b): step 3's shape at K=260, 17 key words with ctx in the pad
    # bits: the synthetic stream (8% sentinel rows mid-stream), then the
    # planes step 3 sorted in phase 6 (a few padding rows a tile)
    t0 = time.time()
    planes = kmer_stream(17, -(-k2_rows // T) * T, SEED + 17, False, 2)
    check_radix("step3_W17", planes, 17, 4)
    del planes
    torch.cuda.empty_cache()
    check_radix("step3_own", *step3_stream)
    del step3_stream
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
