"""Benchmark: step 2's kmer-counting chain on one card.

    python -m w2rap_contigger_tpu_torch.bench [--device cuda|cpu] [--reads N]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}, the keys of the repo root's bench.py (the JAX package's
benchmark, whose input this module generates the same way).

Input: a random 4.6 Mbp genome (seed 42) and 131,072 reads of 250 bases
drawn from it, with 0.3% substitutions; 2% of the qualities are 2, the
rest 35.  W2RAP_SORT (lax, radix or pallas) picks the sort back end.

Metric: canonical k=60 kmers counted per second per card,
n_reads x (L - k + 1) over the device time of one kernel chain: K1
(kmerize + canonicalize) over the already uploaded chunks into a new
Stream, then count_epilogues (the sort under the chosen back end, K2
collapse, compaction into the device-resident dictionary).  These are
the stages ops.kmer_engine.count_kmers_device composes.  The chain is
timed with CUDA events, once to warm up and then CHAINS times; `value`
takes the median.

Why the qualities are not salted, as bench.py salts them: XLA may hoist
or reuse a loop-invariant program, and eager PyTorch does neither.  In
the port the qualities enter on the host (pack_and_glen_host folds them
into the usable lengths before K1), so a salt would time a host re-pack,
not a kernel.  Instead every chain must return a dictionary of the same
size, and the first chain's words, counts and ctx must equal those of
count_kmers_device on the same input.

Baseline: BASELINE_KMERS_PER_SEC = 8.4e7, from the reference (-O2; its
-Ofast miscompiles under gcc 13) measured on a 2-core box: 240k PE250
reads (45.8M kmers) took buildReadQGraph 8.7 s on 2 cores = 2.6M
kmers/s a core; at 1.1M reads (210.1M kmers, E. coli 4.6 Mbp at 30x)
90.9 s at -t 1 and 46.0 s at -t 2 = 2.31M kmers/s a core, with 99% 1->2
core scaling.  The reference's shared-nothing OMP task tree
(BuildReadQGraph.cc:1015-1048) supports linear scaling, so the higher
per-core rate x 32 cores = 8.4e7 kmers/s is the denominator (the E. coli
rate would give 7.4e7: vs_baseline is conservative by about 14%).

detail: the end-to-end count_kmers_device (host pack, upload, chain;
the dictionary stays on the card, so nothing is downloaded but the
101-bin histogram) cold (its first call in the process, after the
chains) and warm; the host pack alone; pinned host-to-device and
device-to-host copy rates (8 MiB and 16 MiB); the chain's peak device
memory; each kernel's launches in one chain; the radix recounts (an
exact lax recount after a slot overflow or a collision; 0 expected);
the card's name and power limit as nvidia-smi gives them; and a sha256
of the dictionary (words, counts, ctx), to compare back ends.

With --device cpu (the tests) the plain PyTorch versions run, timed by
the host clock, and the copy rates, memory and card are null.  With no
card and no --device cpu, resolve_device raises: there is no fallback.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from . import device as tdev
from .ops import kmer_engine as tke
from .ops.kmerize import pack_and_glen_host

BASELINE_KMERS_PER_SEC = 8.4e7
K, READ_LEN, GENOME_LEN, SEED = 60, 250, 4_600_000, 42
N_READS = 131072
CHAINS = 3
MIN_QUAL, MIN_FREQ, CHUNK_READS = 7, 4, 65536


def synthetic_reads(n_reads: int):
    """bench.py:63-75's input: (bases, lengths, quals) of n_reads reads."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    bases = genome[starts[:, None] + np.arange(READ_LEN)[None, :]].astype(np.uint8)
    err = rng.random((n_reads, READ_LEN)) < 0.003
    bases = np.where(err, (bases + 1) % 4, bases).astype(np.uint8)
    quals = np.full((n_reads, READ_LEN), 35, dtype=np.uint8)
    quals[rng.random((n_reads, READ_LEN)) < 0.02] = 2
    lengths = np.full(n_reads, READ_LEN, dtype=np.int32)
    return bases, lengths, quals


def dict_sha256(d) -> str:
    """sha256 over a dictionary's words, counts and ctx."""
    h = hashlib.sha256()
    for t in (d.words, d.cnt, d.ctx):
        h.update(t.cpu().numpy().astype(np.int64).tobytes())
    return h.hexdigest()


def same_dict(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in ((a.words, b.words), (a.cnt, b.cnt),
                                              (a.ctx, b.ctx)))


class Clock:
    """Seconds of the work between start() and stop(): CUDA events on a
    card, the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.t1.record()
            torch.cuda.synchronize()
            return self.t0.elapsed_time(self.t1) / 1e3
        return time.perf_counter() - self.t0


def copy_rates(dev: torch.device) -> tuple[float | None, float | None]:
    """(host-to-device MB/s of a pinned 8 MiB buffer, device-to-host MB/s
    of a pinned 16 MiB one), each the median of 3 copies after a warm-up;
    (None, None) on the CPU."""
    if dev.type != "cuda":
        return None, None
    clock = Clock(dev)
    rates = []
    for n, up in ((8 << 20, True), (16 << 20, False)):
        host = torch.zeros(n, dtype=torch.uint8, pin_memory=True)
        card = torch.zeros(n, dtype=torch.uint8, device=dev)
        src, dst = (host, card) if up else (card, host)
        dst.copy_(src, non_blocking=True)
        times = []
        for _ in range(3):
            clock.start()
            dst.copy_(src, non_blocking=True)
            times.append(clock.stop())
        rates.append(n / 1e6 / statistics.median(times))
    return rates[0], rates[1]


def card_name() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return None
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else None


def run(device: str = "cuda", n_reads: int = N_READS) -> dict:
    """The benchmark's JSON object (see the module docstring)."""
    dev = tdev.resolve_device(device)
    backend = tke.sort_backend()
    bases, lengths, quals = synthetic_reads(n_reads)
    n, L = bases.shape
    capacity = n * (L - K + 1)  # count_kmers_device's stream
    chunks = list(tke._device_chunks(bases, lengths, quals, K, MIN_QUAL, CHUNK_READS, dev))
    clock = Clock(dev)
    recounts = tke.RADIX_RECOUNTS

    def chain():
        return tke._count_chunks(chunks, capacity, K, L, MIN_FREQ, dev, "bench.count")

    first, first_hist = chain()  # the warm-up
    sizes, times = [first.size], []
    for _ in range(CHAINS):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tdev.reset_launches()
        clock.start()
        d, _ = chain()
        times.append(clock.stop())
        sizes.append(d.size)
        del d
    launches = {name: v for name, v in tdev.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if len(set(sizes)) != 1:
        raise RuntimeError(f"the chains' dictionaries differ in size: {sizes}")

    t0 = time.perf_counter()
    e2e, e2e_hist = tke.count_kmers_device(bases, lengths, quals, K, MIN_QUAL, MIN_FREQ,
                                           CHUNK_READS, device=dev)
    tdev.synchronize(dev)
    cold_s = time.perf_counter() - t0
    if not (same_dict(first, e2e) and np.array_equal(first_hist, e2e_hist)):
        raise RuntimeError("the chain's dictionary differs from count_kmers_device's")
    del e2e
    t0 = time.perf_counter()
    e2e, _ = tke.count_kmers_device(bases, lengths, quals, K, MIN_QUAL, MIN_FREQ,
                                    CHUNK_READS, device=dev)
    tdev.synchronize(dev)
    e2e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack_and_glen_host(bases, quals, lengths, K, MIN_QUAL)
    pack_s = time.perf_counter() - t0
    h2d, d2h = copy_rates(dev)

    chain_s = statistics.median(times)
    n_kmers = n * (L - K + 1)
    rate = n_kmers / chain_s
    return {
        "metric": "k60_kmers_counted_per_sec_per_chip",
        "value": rate,
        "unit": "kmers/s",
        "vs_baseline": rate / BASELINE_KMERS_PER_SEC,
        "detail": {
            "kernel_wall_s": chain_s,
            "chain_s": times,
            "end_to_end_kmers_per_sec": n_kmers / e2e_s,
            "end_to_end_wall_s": e2e_s,
            "end_to_end_cold_s": cold_s,
            "host_pack_s": pack_s,
            "h2d_MBps": h2d,
            "d2h_MBps": d2h,
            "chain_max_memory_allocated": peak,
            "launches_per_chain": launches,
            "radix_recounts": tke.RADIX_RECOUNTS - recounts,
            "chain_equals_count_kmers_device": True,
            "dict_sha256": dict_sha256(first),
            "dict_download_mb": 0.0,
            "dev_dict": True,
            "reads": n,
            "kmer_windows": n_kmers,
            "unique_kmers": first.size,
            "sort_backend": backend,
            "device": str(dev),
            "card": card_name() if dev.type == "cuda" else None,
            "baseline": "measured reference -O2: 2.6M kmers/s/core x 32",
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; needs a card) or cpu (plain versions)")
    ap.add_argument("--reads", type=int, default=N_READS, help="reads of 250 bases")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.reads)), flush=True)


if __name__ == "__main__":
    main()
