"""ReadSet — the dense tensor replacement for vecbvec + VecPQVec.

The reference stores reads as a MasterVec of 2-bit packed BaseVecs plus
block-compressed quality PQVecs (src/feudal/BaseVec.h, src/feudal/PQVec.h).
TPU-first redesign: one dense (N, Lmax) uint8 code matrix plus a length
vector — fixed shapes, directly shardable, kernel-friendly.  Reads are
paired by adjacency: read 2i and 2i+1 are a pair (reference PairsManager
convention for innie PE libraries, src/PairsManager.h:120).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadSet:
    bases: np.ndarray  # (N, Lmax) uint8 base codes, 0-padded past length
    lengths: np.ndarray  # (N,) int32
    quals: np.ndarray  # (N, Lmax) uint8 phred scores, 0-padded

    def __post_init__(self):
        assert self.bases.shape == self.quals.shape
        assert self.bases.shape[0] == self.lengths.shape[0]

    @property
    def n_reads(self) -> int:
        return self.bases.shape[0]

    @property
    def max_len(self) -> int:
        return self.bases.shape[1]

    def total_bases(self) -> int:
        return int(self.lengths.sum())

    @staticmethod
    def from_sequences(seqs, quals=None) -> "ReadSet":
        """Build from a list of code arrays (uint8) and optional qual arrays."""
        n = len(seqs)
        lmax = max((len(s) for s in seqs), default=0)
        bases = np.zeros((n, lmax), dtype=np.uint8)
        qmat = np.zeros((n, lmax), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, s in enumerate(seqs):
            l = len(s)
            lengths[i] = l
            bases[i, :l] = s
            if quals is not None:
                qmat[i, :l] = quals[i]
            else:
                qmat[i, :l] = 40
        return ReadSet(bases, lengths, qmat)

    def save(self, path: str) -> None:
        np.savez(
            path, bases=self.bases, lengths=self.lengths, quals=self.quals
        )

    @staticmethod
    def load(path: str) -> "ReadSet":
        with np.load(path) as z:
            return ReadSet(z["bases"], z["lengths"], z["quals"])
