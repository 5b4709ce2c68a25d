"""ReadPathVec — ragged container for read walks through the HBV.

Reference: ReadPath = vector<int> of HBV edge ids + signed start offset in
bases (src/paths/long/ReadPath.h:25-57); ReadPathVec is its MasterVec;
the inverted index (edge -> read ids) is built by invert()
(src/VecUtilities.h:693).

Here: one flat int32 edge array + (N+1) offsets + (N,) int32 start
offsets; the inverted index is a CSR built by counting sort.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadPathVec:
    offsets: np.ndarray  # (N+1,) int64 into edges
    edges: np.ndarray  # flat int32 HBV edge ids
    start: np.ndarray  # (N,) int32 signed base offset of read on first edge

    @property
    def n_reads(self) -> int:
        return len(self.start)

    def path(self, i: int) -> np.ndarray:
        return self.edges[self.offsets[i] : self.offsets[i + 1]]

    def path_len(self):
        return np.diff(self.offsets)

    @staticmethod
    def from_lists(paths, starts) -> "ReadPathVec":
        n = len(paths)
        lens = np.array([len(p) for p in paths], dtype=np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(lens)
        flat = np.zeros(int(offsets[-1]), dtype=np.int32)
        for i, p in enumerate(paths):
            flat[offsets[i] : offsets[i + 1]] = p
        return ReadPathVec(offsets, flat, np.asarray(starts, dtype=np.int32))

    def save(self, path: str) -> None:
        np.savez(
            path, offsets=self.offsets, edges=self.edges, start=self.start
        )

    @staticmethod
    def load(path: str) -> "ReadPathVec":
        with np.load(path) as z:
            return ReadPathVec(z["offsets"], z["edges"], z["start"])


def invert_paths(paths: ReadPathVec, n_edges: int):
    """Edge -> (read_id, position-in-path) CSR index.

    Returns (offsets (E+1,) int64, read_ids flat int64).  Matches the
    reference's paths_inv = invert(paths) (VecUtilities.h:693): for each
    edge, the sorted list of read ids whose path contains it (one entry
    per occurrence).
    """
    edge_of = paths.edges
    counts = np.bincount(edge_of, minlength=n_edges)
    offsets = np.zeros(n_edges + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)
    # read id per flat path position
    read_of = np.repeat(
        np.arange(paths.n_reads, dtype=np.int64), np.diff(paths.offsets)
    )
    order = np.argsort(edge_of, kind="stable")  # stable => read ids sorted
    return offsets, read_of[order]
