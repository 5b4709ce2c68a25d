"""Counts behind the port's partition-sort design, on the CPU.

    python3 scripts/radix_stats.py R1.fastq,R2.fastq [--tile_rows 64 16]

For k=60 over the reads: (1) the distinct kmers and the adjacent pairs of
distinct kmers (in sorted order) that share their first 2 words (64 bits)
or their first 4: a 2-word comparator flags every such pair as a possible
collision and makes the JAX radix back end recount; (2) for each tile
size, the per-bin row loads of the port's radix stream (invalid windows
dropped, padding spread over the tiles), their largest value against the
overflow threshold cap - 128, and the overflow count.  Counts only: the
plain PyTorch versions run on the CPU, so no time is printed.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from w2rap_contigger_tpu_torch.core.io_fastq import extract_reads  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke  # noqa: E402
from w2rap_contigger_tpu_torch.ops import radix  # noqa: E402


def shared_prefix_pairs(reads, k: int):
    os.environ["W2RAP_SORT"] = "lax"
    d, _ = tke.count_kmers_device(reads.bases, reads.lengths, reads.quals, k,
                                  min_freq=1, device="cpu")
    w = d.words
    eq2 = (w[1:, :2] == w[:-1, :2]).all(dim=1)
    eq4 = (w[1:, :4] == w[:-1, :4]).all(dim=1)
    return d.size, int(eq2.sum()), int(eq4.sum())


def bin_loads(reads, k: int, tile_rows: int):
    """Per-(tile, bin) loads of the partition sort inside the port's radix
    count, read off its partition phase."""
    seen = {}
    plain = radix.partition_plain

    def spy(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys, cmp_keys, T, n_bins, cap):
        out = plain(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys, cmp_keys,
                    T, n_bins, cap)
        n = planes.shape[1]
        tile = torch.arange(n) // T
        sent = (planes[:num_keys] == -1).all(dim=0)
        below = [torch.zeros(n // T, dtype=torch.int64)]
        hs, ls = radix.u64_order(s_hi), radix.u64_order(s_lo)
        for b in range(n_bins - 1):
            kh, kl = radix.u64_order(sp_hi[b]), radix.u64_order(sp_lo[b])
            lt = (hs < kh) | ((hs == kh) & (ls < kl))
            below.append(torch.bincount(tile[lt], minlength=n // T))
        below.append(T - torch.bincount(tile[sent], minlength=n // T))
        loads = torch.stack(below)[1:] - torch.stack(below)[:-1]
        seen.update(rows=n, T=T, bins=n_bins, threshold=cap - 128,
                    max_load=int(loads.max()), mean_load=float(loads.float().mean()),
                    overflow=int(out[3][0]))
        return out

    os.environ["W2RAP_SORT"] = "radix"
    radix.partition_plain = spy
    radix.DEFAULT_TILE_ROWS, old = tile_rows, radix.DEFAULT_TILE_ROWS
    try:
        tke.count_kmers_device(reads.bases, reads.lengths, reads.quals, k, device="cpu")
    finally:
        radix.partition_plain = plain
        radix.DEFAULT_TILE_ROWS = old
    return seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads", help="R1.fastq,R2.fastq")
    ap.add_argument("-k", type=int, default=60)
    ap.add_argument("--tile_rows", type=int, nargs="+", default=[64, 16])
    args = ap.parse_args()
    reads = extract_reads(args.reads)
    size, p2, p4 = shared_prefix_pairs(reads, args.k)
    print(f"[prefix] k={args.k} reads={reads.n_reads} distinct_kmers={size} "
          f"adjacent_pairs_sharing_64_bits={p2} sharing_128_bits={p4}", flush=True)
    for tr in args.tile_rows:
        s = bin_loads(reads, args.k, tr)
        print("[loads] " + " ".join(f"{key}={v}" for key, v in s.items()), flush=True)


if __name__ == "__main__":
    main()
