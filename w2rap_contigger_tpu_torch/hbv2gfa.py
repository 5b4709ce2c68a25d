"""hbv2gfa — graph stats (N10..N90, NG) + GFA dump from a checkpoint.

Reference: src/modules/hbv2gfa.cc:10-100 (the second shipped binary).

Usage: python -m w2rap_contigger_tpu_torch.hbv2gfa -i PREFIX -o OUT_PREFIX
       [-g GENOME_SIZE_KBP] [--stats_only]
"""

from __future__ import annotations

import argparse

import numpy as np

from .graph import validate
from .graph.hbv import HyperBasevector


def nxx_stats(hbv: HyperBasevector, genome_size: int = 0):
    """Canonical-edge N10..N90 (+NG10..NG90 with a genome size).

    An edge counts once per involution pair (FWD/palindromic copy only),
    matching hbv2gfa.cc:60-70.
    """
    lens = hbv.edge_len()
    canon = np.minimum(np.arange(hbv.n_edges), hbv.inv) == np.arange(
        hbv.n_edges
    )
    sizes = np.sort(lens[canon])[::-1]
    canonical_size = int(sizes.sum())
    out = {"canonical_size": canonical_size}
    for denom, tag in ((canonical_size, "N"), (genome_size, "NG")):
        if not denom:
            continue
        cs = 0
        si = 0
        for i in range(10, 100, 10):
            while si < len(sizes) and cs * 100.0 / denom < i:
                cs += int(sizes[si])
                si += 1
            if si == 0 or (tag == "NG" and si >= len(sizes) and cs * 100.0 / denom < i):
                out[f"{tag}{i}"] = None
            else:
                out[f"{tag}{i}"] = int(sizes[si - 1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hbv2gfa")
    ap.add_argument("-i", "--in_prefix", required=True)
    ap.add_argument("-o", "--out_prefix", required=True)
    ap.add_argument("-g", "--genome_size", type=int, default=0, help="Kbp")
    ap.add_argument("--stats_only", action="store_true")
    args = ap.parse_args(argv)

    hbv = HyperBasevector.load(args.in_prefix + ".hbv.npz")
    validate.test_involution(hbv)
    stats = nxx_stats(hbv, 1000 * args.genome_size)
    print("=== Graph stats ===")
    print(f"Canonical graph sequences size: {stats['canonical_size']}")
    for k, v in stats.items():
        if k != "canonical_size":
            print(f"{k}: {v if v is not None else 'n/a'}")
    if not args.stats_only:
        from .graph import gfa

        gfa.gfa_dump(hbv, args.out_prefix)


if __name__ == "__main__":
    main()
