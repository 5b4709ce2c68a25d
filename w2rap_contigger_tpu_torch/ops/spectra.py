"""KmerSpectrum — kmer-frequency histogram with genome-size analysis.

Parity with ``src/kmers/KmerSpectra.h:15-118``: a histogram indexed by
kmer frequency supporting merge (operator+), increment, weighted sums,
and an ``analyze`` pass that locates the error/signal valley
(``kf_min1``), the main coverage peak (``kf_max1``) and estimates
unique/repetitive/total genome size. (The reference header declares
``analyze`` but its implementation is not shipped in this tree; the
estimator here is the standard spectrum analysis: genome_size =
Σ_{f ≥ kf_min1} f·N(f) / kf_max1, with the repetitive share taken from
frequencies above ploidy·kf_max1·3/2.)

The histogram itself is produced on device (a psum over per-chip
bincounts — parallel/mesh.py); this class is the host-side container,
matching the role of the reference's ``small_K.freqs`` dump
(BuildReadQGraph.cc:1111-1115).
"""

from __future__ import annotations

import numpy as np


class KmerSpectrum:
    def __init__(self, k: int, counts=None):
        self.k = int(k)
        self.counts = (np.zeros(0, dtype=np.int64) if counts is None
                       else np.asarray(counts, dtype=np.int64).copy())
        self.kf_min1 = 0
        self.kf_max1 = 0
        self.genome_size_unique = 0
        self.genome_size_repetitive = 0
        self.genome_size = 0

    def increment(self, kf: int, n: int = 1) -> None:
        if len(self.counts) <= kf:
            grown = np.zeros(kf + 1, dtype=np.int64)
            grown[:len(self.counts)] = self.counts
            self.counts = grown
        self.counts[kf] += n

    def __add__(self, other: "KmerSpectrum") -> "KmerSpectrum":
        assert self.k == other.k
        n = max(len(self.counts), len(other.counts))
        out = np.zeros(n, dtype=np.int64)
        out[:len(self.counts)] += self.counts
        out[:len(other.counts)] += other.counts
        return KmerSpectrum(self.k, out)

    def sum(self) -> int:
        return int(self.counts.sum())

    def sum_weighted(self) -> int:
        return int((np.arange(len(self.counts)) * self.counts).sum())

    def analyze(self, ploidy: int = 1, kf_min1_arg: int = 10) -> None:
        """Locate the error valley + main peak, estimate genome size."""
        c = self.counts
        if len(c) < 4:
            return
        # valley: first local minimum after frequency 1 (capped by arg)
        hi = min(len(c) - 1, max(3, kf_min1_arg * 10))
        kf_min1 = 1
        for f in range(2, hi):
            if c[f] <= c[f - 1] and c[f] <= c[f + 1]:
                kf_min1 = f
                break
        # main peak: argmax past the valley
        if kf_min1 + 1 >= len(c):
            return
        kf_max1 = int(np.argmax(c[kf_min1:])) + kf_min1
        self.kf_min1, self.kf_max1 = kf_min1, kf_max1
        if kf_max1 == 0:
            return
        f = np.arange(len(c))
        signal = f >= kf_min1
        total_kmers = (f[signal] * c[signal]).sum()
        self.genome_size = int(round(total_kmers / kf_max1))
        rep_cut = int(ploidy * kf_max1 * 3 / 2)
        rep = signal & (f > rep_cut)
        self.genome_size_repetitive = int(round(
            (f[rep] * c[rep]).sum() / kf_max1))
        self.genome_size_unique = (self.genome_size
                                   - self.genome_size_repetitive)

    @classmethod
    def from_kmer_counts(cls, k: int, kmer_counts) -> "KmerSpectrum":
        """Histogram from per-kmer multiplicities (device bincount)."""
        kc = np.asarray(kmer_counts, dtype=np.int64)
        return cls(k, np.bincount(kc[kc > 0]))
