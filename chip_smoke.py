"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py   # needs one NVIDIA GPU

Phases, each printing its results on a line of its own; any failure
exits non-zero and prints no result line:

1. probe the card (torch.cuda, nvidia-smi name and power limit);
2. build the CUDA kernels from csrc/ with nvcc;
3. each kernel against its plain PyTorch version, element by element, on
   the card at the main path's shapes (K1 kmerize on one 65536-read chunk
   at k=60 and k=200, L=250; K2 collapse on sorted W=4 and W=13 streams
   with cross-tile runs, runs longer than a tile, counts above 255 and
   sentinels), with both times;
4. step 2 through the port's CLI entry on a 200 kb genome / 24k PE250
   pairs, --device cuda against --device cpu: small_K.freqs, HBV and
   paths must be identical;
5. step 2 at E. coli scale (4.6 Mbp, 550k PE250 pairs, seed 42) on the
   card with W2RAP_TIMELOG=1: both kernels launched, graph and paths
   validated, step split and peak device memory printed.

Then one JSON line of the kernels, and last the device JSON line.
Tolerance everywhere: exact equality (integer and bit-pattern data).
"""

from __future__ import annotations

import argparse
import json
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
from w2rap_contigger_tpu_torch.ops import _build  # noqa: E402
from w2rap_contigger_tpu_torch.ops import collapse as kcol  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmerize as kkm  # noqa: E402
from w2rap_contigger_tpu_torch.ops.bitkmer import to_raw32  # noqa: E402
from w2rap_contigger_tpu_torch.shared import sysinfo, validate  # noqa: E402

SEED = 42
CHUNK_READS = 65536
READ_LEN = 250
ECOLI = {"glen": 4_600_000, "pairs": 550_000}
SMALL = {"glen": 200_000, "pairs": 24_000}


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


def max_abs_err(a, b) -> int:
    """Largest |difference| of the u32 values (0 when bit-identical)."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            fail(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            d = (x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
    return err


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
# phase 3: kernels against their plain versions
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
    pr_d = torch.from_numpy(pr.view(np.int32)).cuda()
    gl_d = torch.from_numpy(glen).cuda()
    got = kkm.kmerize(pr_d, gl_d, k, READ_LEN)
    want = kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err or not torch.equal(got, want):
        fail(f"K1 kmerize k={k} differs from its plain version (max_abs_err {err})")
    ms = time_ms(lambda: kkm.kmerize(pr_d, gl_d, k, READ_LEN))
    plain_ms = time_ms(lambda: kkm.kmerize_plain(pr_d, gl_d, k, READ_LEN))
    rows = got.shape[1]
    valid = int((got[0] != -1).sum())
    say("kmerize", k=k, reads=CHUNK_READS, L=READ_LEN, rows=rows, valid_rows=valid,
        max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def sorted_stream(W: int, n: int, seed: int) -> torch.Tensor:
    """(W+1, n) int32 sorted stream: ~95% real rows in segments whose
    lengths mix typical coverage (1..60), repeats longer than a tile
    (5000..20000 rows) and one run above 100k rows; payload cnt 1..3 so
    sums pass 255; then all-ones sentinel rows with payload 0."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"
    n_real = int(n * 0.95)
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
    out = torch.full((W + 1, n), -1, dtype=torch.int32, device=dev)
    out[:W, :n_real] = to_raw32(rows)
    out[W] = 0
    out[W, :n_real] = to_raw32((ctx << 8) | cnt)
    return out


def check_collapse(W: int, n: int, min_count: int):
    planes = sorted_stream(W, n, SEED + W)
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
    say("collapse", W=W, rows=n, min_count=min_count, kept=kept,
        low_bins=got[2][1:min_count].tolist(), max_abs_err=err,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    del planes, got
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phases 4-5: the port's step 2 through its CLI entry
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


def run_cli(data: str, out: str, device: str, extra=()):
    return cli.main([
        "-r", f"{data}/reads_R1.fastq,{data}/reads_R2.fastq", "-o", out,
        "--to_step", "2", "--device", device, *extra,
    ])


def same_outputs(a: str, b: str) -> list[str]:
    diffs = []
    with open(f"{a}/small_K.freqs", "rb") as fa, open(f"{b}/small_K.freqs", "rb") as fb:
        if fa.read() != fb.read():
            diffs.append("small_K.freqs")
    for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
        za, zb = np.load(f"{a}/{name}"), np.load(f"{b}/{name}")
        if sorted(za.files) != sorted(zb.files):
            diffs.append(f"{name}: keys")
            continue
        for key in za.files:
            if za[key].shape != zb[key].shape or not np.array_equal(za[key], zb[key]):
                diffs.append(f"{name}:{key}")
    return diffs


def phase_parity(work: str):
    data = f"{work}/s200"
    gen_s = synth(data, **SMALL)
    times = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        run_cli(data, f"{data}/{dev}", dev)
        times[dev] = time.time() - t0
    diffs = same_outputs(f"{data}/cuda", f"{data}/cpu")
    if diffs:
        fail(f"200 kb step 2: cuda and cpu outputs differ in {diffs}")
    say("parity_200kb", genome=SMALL["glen"], pairs=SMALL["pairs"],
        synth_s=f"{gen_s:.1f}", cuda_s=f"{times['cuda']:.2f}",
        cpu_s=f"{times['cpu']:.2f}", identical=True)


def phase_scale(work: str) -> dict:
    data = f"{work}/ecoli"
    gen_s = synth(data, **ECOLI)
    os.environ["W2RAP_TIMELOG"] = "1"
    sysinfo.timelog_reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tdev.reset_launches()
    t0 = time.time()
    hbv, paths, d = run_cli(data, f"{data}/out", "cuda", ["--dump_perf"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(tdev.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    split = {}
    for line in sysinfo.timelog_report().splitlines():
        _, name, secs, _ = [x.strip() for x in line.split(",")]
        split[name] = secs
    with open(f"{data}/out/pe.perf") as f:
        perf = " | ".join(x.strip() for x in f)
    say("ecoli_step2", genome=ECOLI["glen"], pairs=ECOLI["pairs"], reads=paths.n_reads,
        synth_s=f"{gen_s:.1f}", wall_s=f"{wall:.2f}", unique_kmers=d.size,
        edges=hbv.n_edges, path_edges=len(paths.edges),
        max_memory_allocated=peak, launches=json.dumps(launches))
    say("ecoli_split", **split)
    say("ecoli_perf", perf=repr(perf))
    return launches


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    card = phase_probe()
    phase_build()
    k1 = check_kmerize(60)
    check_kmerize(200)
    k2 = check_collapse(4, 1_100_000 * (READ_LEN - 60 + 1), min_count=4)
    check_collapse(13, 16_000_000, min_count=1)
    with tempfile.TemporaryDirectory(prefix="w2rap_smoke_") as work:
        phase_parity(work)
        launches = phase_scale(work)

    kernels = [
        {"name": "kmerize", "route": "cuda",
         "source": "w2rap_contigger_tpu_torch/csrc/kmerize.cu",
         "replaces": "w2rap_contigger_tpu/ops/pallas_kmer.py:64",
         "launches": launches["kmerize"], **k1},
        {"name": "collapse", "route": "cuda",
         "source": "w2rap_contigger_tpu_torch/csrc/collapse.cu",
         "replaces": "w2rap_contigger_tpu/ops/pallas_collapse.py:83",
         "launches": launches["collapse"], **k2},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
