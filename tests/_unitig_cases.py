"""Dictionaries for the unitig chain assembly's tests, and the comparison
of its device route with the numpy route it replaced, which stays for
host dictionaries: the same edges, in the same order and numbering, the
same KDef planes and the same HBV.  Tolerance: exact equality.  Imports
no JAX, so the `cuda` test of `tests/test_torch_unitigs.py` runs on a
card alone."""

import numpy as np

from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch import state
from w2rap_contigger_tpu_torch.graph import build as tgb
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke


def _palindrome(rng, n):
    half = rng.integers(0, 4, n // 2).astype(np.uint8)
    return np.concatenate([half, (3 - half)[::-1]])


def _tiles(seq, length, step, circular=False):
    if circular:
        seq = np.concatenate([seq, seq[:length]])
    return [seq[s : s + length] for s in range(0, len(seq) - length + 1, step)]


def _flat(pieces):
    seg = np.zeros(len(pieces) + 1, dtype=np.int64)
    seg[1:] = np.cumsum([len(p) for p in pieces])
    return np.concatenate(pieces), seg


def pieces(case, k, seed=3):
    """(flat bases, segment starts) whose k-mers make the case's graph: a
    genome with a repeat and a few errors, and besides it a palindrome of
    k bases (palindromic k-mers: chains that are their mirror's, for the
    tie loop), one of k + 1 (a hairpin link at odd k), a plasmid (a
    smooth cycle), or in place of it an error-free plasmid alone (smooth
    cycles and no linear chain), or k-mers that overlap nothing
    (single-node chains)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    genome[2000:2400] = genome[500:900]
    if case == "palindrome":
        genome[1200 : 1200 + k] = _palindrome(rng, k)
    if case == "hairpin":
        genome[1200 : 1201 + k] = _palindrome(rng, k + 1)
    out = _tiles(genome, 2 * k, 7)
    for i in range(0, len(out), 9):
        out[i] = out[i].copy()
        out[i][k // 2] ^= 1
    if case == "cycle":
        out += _tiles(rng.integers(0, 4, 700).astype(np.uint8), 2 * k, 7, circular=True)
    if case == "circle":
        out = _tiles(rng.integers(0, 4, 700).astype(np.uint8), 2 * k, 7, circular=True)
    if case == "single":
        out = [rng.integers(0, 4, k).astype(np.uint8) for _ in range(300)]
    if case == "empty":
        out = [rng.integers(0, 4, k - 1).astype(np.uint8)]
    return _flat(out)


def card_case(k=60):
    """A few hundred thousand rows: a 150 kb genome with repeats, errors
    and a palindrome, and an error-free 5 kb plasmid, in 250-base tiles."""
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 150_000).astype(np.uint8)
    for s in range(10_000, 150_000, 30_000):
        genome[s : s + 3000] = genome[2000:5000]
    genome[7000 : 7000 + k] = _palindrome(rng, k)
    out = _tiles(genome, 250, 11)
    for i in range(0, len(out), 5):
        out[i] = out[i].copy()
        out[i][rng.integers(0, 250)] ^= 2
    out += _tiles(rng.integers(0, 4, 5000).astype(np.uint8), 250, 11, circular=True)
    return (*_flat(out), k)


def both_routes(flat, seg, k, device):
    """(device-route outputs, numpy-route outputs) on one dictionary,
    each (edge_bases, edge_start, edge_id, edge_offset, edge_rc, the
    ASSEMBLY counts); the device dict; and its host arrays (words,
    counts, ctx) with its adjacencies pruned."""
    d = tke.count_kmers_flat(flat, seg, k, min_freq=1, device="cpu")
    tgb.recompute_adjacencies(d)
    raw = state.dict_to_numpy(d)
    d = state.dict_from_reference(*raw, k, device)
    out = []
    for dd, host in ((d, False), (tke.HostKmerDict(*raw, k), True)):
        tdev.reset_launches()
        eb, es = tgb.build_unitigs(dd, host=host)
        out.append((eb, es, dd.edge_id, dd.edge_offset, dd.edge_rc, dict(tdev.ASSEMBLY)))
    return out, d, raw


def assert_same(got, want, d, k):
    """got and want (both_routes' outputs) equal, and d's device KDef
    planes equal to its host ones."""
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[5] == want[5]
    for plane, host_plane in zip(d.kdef, got[2:5]):
        np.testing.assert_array_equal(plane.cpu().numpy(), host_plane)
    (hbv, fx, rx), (whbv, wfx, wrx) = (tgb.build_hbv_from_edges(o[0], o[1], k) for o in (got, want))
    np.testing.assert_array_equal(fx, wfx)
    np.testing.assert_array_equal(rx, wrx)
    for name in ("edge_bases", "edge_start", "to_left", "to_right", "inv"):
        np.testing.assert_array_equal(getattr(hbv, name), getattr(whbv, name))
    assert hbv.n_vertices == whbv.n_vertices
