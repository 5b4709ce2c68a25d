"""HyperBasevector — the assembly graph as flat tensors.

The reference's HyperBasevector (src/paths/HyperBasevector.h:34) is a
digraphE<basevector>: edges are base sequences that overlap by K-1 at
vertices; both orientations of every edge are present and related by the
involution map (HyperBasevector.cc:648).

TPU-first redesign: a structure-of-arrays graph — flat uint8 base pool +
offset table, to_left/to_right vertex arrays, involution permutation —
so per-edge and per-vertex passes are vectorized gathers instead of
object traversals.  Small-graph surgery mutates the numpy arrays on host;
device kernels take read-only views.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HyperBasevector:
    k: int
    edge_bases: np.ndarray  # flat uint8 base codes of all edges
    edge_start: np.ndarray  # (E+1,) int64 offsets into edge_bases
    to_left: np.ndarray  # (E,) int32 source vertex of each edge
    to_right: np.ndarray  # (E,) int32 target vertex of each edge
    inv: np.ndarray  # (E,) int32 involution: edge -> its rc edge
    n_vertices: int

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return len(self.to_left)

    def edge_len(self, e=None):
        """Edge length in bases ((E,) if e is None)."""
        d = np.diff(self.edge_start)
        return d if e is None else d[e]

    def edge_kmers(self, e=None):
        """Edge length in kmers (reference EdgeLengthKmers)."""
        return self.edge_len(e) - self.k + 1

    def edge_seq(self, e: int) -> np.ndarray:
        return self.edge_bases[self.edge_start[e] : self.edge_start[e + 1]]

    # ------------------------------------------------------------------
    def vertex_csr(self):
        """(from_offsets, from_edges, to_offsets, to_edges) CSR adjacency.

        from_edges lists out-edges per vertex (edges whose to_left == v),
        to_edges lists in-edges per vertex (to_right == v); both sorted by
        edge id within a vertex — mirroring digraphE's sorted adjacency
        (src/graph/Digraph.h:498).
        """
        E, V = self.n_edges, self.n_vertices
        order_out = np.argsort(self.to_left, kind="stable")
        from_offsets = np.zeros(V + 1, dtype=np.int64)
        np.add.at(from_offsets, self.to_left + 1, 1)
        from_offsets = np.cumsum(from_offsets)
        order_in = np.argsort(self.to_right, kind="stable")
        to_offsets = np.zeros(V + 1, dtype=np.int64)
        np.add.at(to_offsets, self.to_right + 1, 1)
        to_offsets = np.cumsum(to_offsets)
        return from_offsets, order_out.astype(np.int32), to_offsets, order_in.astype(np.int32)

    def out_degree(self):
        d = np.zeros(self.n_vertices, dtype=np.int32)
        np.add.at(d, self.to_left, 1)
        return d

    def in_degree(self):
        d = np.zeros(self.n_vertices, dtype=np.int32)
        np.add.at(d, self.to_right, 1)
        return d

    # ------------------------------------------------------------------
    def check_involution(self):
        """TestInvolution equivalent (GapToyTools3.cc:558): inv is an
        involution, maps each edge to its reverse complement, and flips
        vertex structure consistently."""
        E = self.n_edges
        assert self.inv.shape == (E,)
        assert np.all(self.inv[self.inv] == np.arange(E))
        lens = self.edge_len()
        assert np.all(lens[self.inv] == lens)
        # spot-check sequences (full check would be O(total bases); fine)
        for e in range(min(E, 64)):
            re = int(self.inv[e])
            rc = (3 - self.edge_seq(re))[::-1]
            assert np.array_equal(self.edge_seq(e), rc), f"inv seq mismatch {e}"
        # structure: to_left[e] pairs with to_right[inv[e]] under the
        # vertex involution induced by inv
        assert np.all(
            self.to_left[self.inv[self.inv]] == self.to_left
        )

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(
            path,
            k=np.int64(self.k),
            edge_bases=self.edge_bases,
            edge_start=self.edge_start,
            to_left=self.to_left,
            to_right=self.to_right,
            inv=self.inv,
            n_vertices=np.int64(self.n_vertices),
        )

    @staticmethod
    def load(path: str) -> "HyperBasevector":
        with np.load(path) as z:
            return HyperBasevector(
                k=int(z["k"]),
                edge_bases=z["edge_bases"],
                edge_start=z["edge_start"],
                to_left=z["to_left"],
                to_right=z["to_right"],
                inv=z["inv"],
                n_vertices=int(z["n_vertices"]),
            )

    @staticmethod
    def from_edge_list(k: int, seqs: list) -> tuple:
        """Utility used by builders: pack a python list of code arrays."""
        E = len(seqs)
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        edge_start = np.zeros(E + 1, dtype=np.int64)
        edge_start[1:] = np.cumsum(lens)
        flat = np.zeros(int(edge_start[-1]), dtype=np.uint8)
        for i, s in enumerate(seqs):
            flat[edge_start[i] : edge_start[i + 1]] = s
        return flat, edge_start
