"""Peak device memory of step 2's count, stage by stage, on one GPU:
what a hash range's valid rows really cost under -d/-m.

    python3 scripts/range_peak.py --config benchmark/configs/ecoli_k12_pe250.json \
        --seed 11 --runs "4 4" "0 72" [--passes 2] [--out FILE]

Makes the configuration's reads from --seed on the card
(benchmark/data.py), then counts them with
ops.kmer_engine.count_kmers_batched as step 2 calls it, --passes times for
each entry of --runs ("<disk_batches> <max_mem_gb>"; the configuration's
own when --runs is not given).  The peak allocator statistics are read and
reset at each stage's edge: the pack, the sizing sweep, and per range its
K1 sweep (read when the stream is handed to the sort), the sort, K2 and
the compaction.  Each pass prints one JSON line: its wall, peak
(max_memory_allocated over the pass), the device.RANGED counter, the
ranges' rows, each stage's peak, and the peak over the largest range's
valid rows.  A run that runs out of device memory prints the error and
the memory held when it struck, and the script goes on.  The card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark import data  # noqa: E402
from w2rap_contigger_tpu_torch import device as tdev  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as ke  # noqa: E402


def emit(rec: dict, out: str | None) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


class Stages:
    """Wraps kmer_engine's stage functions so that each reads the peak
    since the last edge and resets it: [(stage, peak bytes)]."""

    def __init__(self):
        self.peaks: list[tuple[str, int]] = []
        self.range_rows: list[int] = []
        self._saved = []

    def edge(self, stage: str) -> None:
        torch.cuda.synchronize()
        self.peaks.append((stage, int(torch.cuda.max_memory_allocated())))
        torch.cuda.reset_peak_memory_stats()

    def _wrap(self, owner, name: str, before: str | None, after: str | None):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def wrapped(*a, **kw):
            if before:
                self.edge(before)
            out = fn(*a, **kw)
            if after:
                self.edge(after)
            return out

        setattr(owner, name, wrapped)

    def __enter__(self):
        self._wrap(ke, "range_sizes", "pack", "sizes")
        self._wrap(ke.Stream, "planes", "kmerize", None)
        self._wrap(ke, "_sorted_stream", None, "sort")
        self._wrap(ke, "_collapse_enqueued", None, "collapse")
        self._wrap(ke, "_dict_of", None, "compact")
        ranges_at = ke.ranges_at

        def sizes(*a, **kw):
            out = ranges_at(*a, **kw)
            self.range_rows = list(out)
            return out

        self._saved.append((ke, "ranges_at", ranges_at))
        ke.ranges_at = sizes
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)


def count_pass(cfg: dict, reads, disk_batches: int, max_mem_gb: int) -> dict:
    a = cfg["assembly"]
    bases, lengths, quals = reads
    tdev.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Stages() as st:
        try:
            d, _ = ke.count_kmers_batched(
                bases, lengths, quals, int(a["k"]), min_qual=int(a["min_qual"]),
                min_freq=int(a["min_freq"]), chunk_reads=int(a["chunk_reads"]),
                disk_batches=disk_batches, tmp_dir=None, max_mem_gb=max_mem_gb,
                device="cuda")
            torch.cuda.synchronize()
            oom, kept = None, d.size
            del d
        except torch.OutOfMemoryError as e:
            oom, kept = str(e).splitlines()[0][:300], None
        st.edge("end")
    rec = {"disk_batches": disk_batches, "max_mem_gb": max_mem_gb,
           "wall_s": time.perf_counter() - t0,
           "peak_bytes": max(p for _, p in st.peaks),
           "ranged": dict(tdev.RANGED), "range_rows": st.range_rows,
           "stages": st.peaks, "dict_rows": kept}
    if oom:
        rec.update(oom=oom, allocated_at_oom=int(torch.cuda.memory_allocated()),
                   reserved_at_oom=int(torch.cuda.memory_reserved()))
    if tdev.RANGED["range_rows_max"]:
        rec["bytes_per_range_row"] = rec["peak_bytes"] / tdev.RANGED["range_rows_max"]
    else:
        windows = bases.shape[0] * max(0, bases.shape[1] - int(a["k"]) + 1)
        rec["bytes_per_window"] = rec["peak_bytes"] / windows
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", nargs="+", default=None)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("range_peak: no CUDA card", file=sys.stderr)
        return 1
    with open(args.config) as f:
        cfg = json.load(f)
    os.environ["W2RAP_SORT"] = cfg["assembly"]["sort"]
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except OSError:
        card = None
    emit({"card": card, "config": cfg["name"], "seed": args.seed}, args.out)
    t0 = time.perf_counter()
    reads = data.make_reads(cfg, args.seed, "cuda")
    emit({"reads": int(reads[0].shape[0]), "make_reads_s": time.perf_counter() - t0}, args.out)
    runs = args.runs or [f"{cfg['assembly']['disk_batches']} {cfg['assembly']['max_mem_gb']}"]
    for run in runs:
        disk_batches, max_mem_gb = (int(x) for x in run.split())
        for i in range(args.passes):
            rec = count_pass(cfg, reads, disk_batches, max_mem_gb)
            emit({"pass": i, **rec}, args.out)
            if "oom" in rec:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
