"""Line coverage, copy-number calls and fragment-size distribution.

Reference:
* ComputeCoverage (src/paths/long/large/Lines.cc:442-560): pairs touching
  each line -> coverage per kmer -> CN1 peak normalization
* CN1PeakFinder (src/paths/long/large/CN1PeakFinder.h:15): modal-coverage
  peak detection (here: max-mass candidate, the reference's MaxPeak seed)
* CNIntegerFraction (GapToyTools5.cc:1520; defaults frac=0.1,
  min_edge_size=2000)
* FragDist (GapToyTools3.cc:616): innie pair separations on long edges,
  10-base bins to 1000.
"""

from __future__ import annotations

import numpy as np

MIN_LINE = 1000
TOP_GROUP = 50
RADIUS = 0.08


def _tol(hbv, lines):
    """GetTol: edge -> line id (-1 when on no line)."""
    tol = np.full(hbv.n_edges, -1, dtype=np.int64)
    for i, L in enumerate(lines):
        for cell in L:
            for p in cell:
                for e in p:
                    tol[e] = i
    return tol


def compute_coverage(hbv, paths, lines):
    """Single-sample ComputeCoverage.  Returns (covs (E,) float with NaN
    for undefined, base_cov)."""
    from ..graph.lines import get_line_lengths

    inv = hbv.inv
    tol = _tol(hbv, lines)
    nl = len(lines)
    npairs = np.zeros(nl, dtype=np.int64)
    npids = paths.n_reads // 2
    if nl and paths.edges.size:
        # vectorized pair->line incidence (was a per-pair Python loop):
        # key pid*nl + line, np.unique collapses repeat touches within
        # a pair, bincount tallies per line
        read_of = np.repeat(
            np.arange(paths.n_reads, dtype=np.int64), paths.path_len()
        )
        in_pair = read_of < 2 * npids
        pid = read_of[in_pair] >> 1
        e = paths.edges[in_pair]
        ls = np.concatenate([tol[e], tol[inv[e]]])
        pids = np.concatenate([pid, pid])
        m = ls >= 0
        key = pids[m] * np.int64(nl) + ls[m]
        uniq = np.unique(key)
        npairs = np.bincount((uniq % nl).astype(np.int64), minlength=nl)

    lens = get_line_lengths(hbv, lines)
    covl = np.where(lens > 0, npairs / np.maximum(lens, 1), 0.0)

    # baseline: median of top-50 longest lines, refined by the CN1 peak
    order = np.argsort(-lens, kind="stable")
    top = np.sort(covl[order[: min(TOP_GROUP, nl)]])
    base_cov = float(np.median(top)) if len(top) else 0.0

    max_len = int(lens.max()) if nl else 0
    min_len = min(10000, max_len // 2)
    sel = np.flatnonzero((lens >= min_len) & (covl > 0))
    if len(sel):
        covx = covl[sel]
        ids = sel[np.argsort(covx, kind="stable")]
        covx = np.sort(covx)
        mass = np.zeros(len(covx), dtype=np.int64)
        for i in range(len(covx)):
            m = lens[ids[i]]
            j = i - 1
            while j >= 0 and covx[i] - covx[j] <= RADIUS * covx[i]:
                m += lens[ids[j]]
                j -= 1
            j = i + 1
            while j < len(covx) and covx[j] - covx[i] <= RADIUS * covx[i]:
                m += lens[ids[j]]
                j += 1
            mass[i] = m
        peak = float(covx[int(np.argmax(mass))])  # CN1PeakFinder::MaxPeak
        if peak > 0:
            base_cov = peak

    covs = np.full(hbv.n_edges, np.nan)
    if base_cov > 0:
        for l, L in enumerate(lines):
            if lens[l] >= MIN_LINE:
                for j in range(0, len(L), 2):
                    e = L[j][0][0]
                    covs[e] = covl[l] / base_cov
    return covs, base_cov


def cn_integer_fraction(hbv, covs, frac=0.1, min_edge_size=2000):
    """CNIntegerFraction (GapToyTools5.cc:1520)."""
    lens = hbv.edge_len()
    sel = (lens >= min_edge_size) & ~np.isnan(covs)
    if not sel.any():
        return 0.0
    c = covs[sel]
    good = np.abs(np.round(c) - c) <= frac
    return float(good.sum() / sel.sum())


def frag_dist(hbv, paths, out_file):
    """FragDist (GapToyTools3.cc:616): separations of innie pairs whose
    reads both start on the same >=10kb edge; 10-base bins to 1000."""
    WIDTH, MAX_SEP, MIN_EDGE = 10, 1000, 10000
    inv = hbv.inv
    elen = hbv.edge_len()
    count = np.zeros(MAX_SEP // WIDTH, dtype=np.float64)
    npids = paths.n_reads // 2
    if npids and paths.edges.size:
        # vectorized over all pairs (was a per-pair Python loop)
        off = paths.offsets
        plen = np.diff(off)
        l1 = plen[0 : 2 * npids : 2]
        l2 = plen[1 : 2 * npids : 2]
        both = (l1 > 0) & (l2 > 0)
        pid = np.flatnonzero(both)
        hi = max(paths.edges.size - 1, 0)
        e1 = paths.edges[np.minimum(off[2 * pid], hi)].astype(np.int64)
        e2 = inv[paths.edges[np.minimum(off[2 * pid + 1], hi)]].astype(
            np.int64
        )
        ok = (e1 == e2) & (elen[e1] >= MIN_EDGE)
        pid, e2 = pid[ok], e2[ok]
        sep = (
            elen[e2].astype(np.int64)
            - paths.start[2 * pid + 1].astype(np.int64)
            - paths.start[2 * pid].astype(np.int64)
        )
        sep = sep[(sep >= 0) & (sep < MAX_SEP)]
        count += np.bincount(sep // WIDTH, minlength=MAX_SEP // WIDTH)
    total = count.sum()
    with open(out_file, "w") as f:
        f.write("# fragment library size distribution\n")
        f.write("# bins have diameter 10\n# line format:\n# bin_center mass\n")
        for j in range(len(count)):
            mass = count[j] / total if total else 0.0
            f.write(f"{j * WIDTH + WIDTH // 2} {mass}\n")
    return count
