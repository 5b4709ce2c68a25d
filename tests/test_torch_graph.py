"""Graph construction and read pathing of the port (torch on the CPU)
against the JAX package, both started from one dictionary carried across
by `state`: adjacencies, links, list ranking, unitigs, HBV, the compact
lookup and path_reads (with a chunk that takes the dense fallback).
Tolerance: exact equality."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.graph import build as gb
from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu.paths import pather as jpather
from w2rap_contigger_tpu_torch import state
from w2rap_contigger_tpu_torch.graph import build as tgb
from w2rap_contigger_tpu_torch.ops import bitkmer as bk
from w2rap_contigger_tpu_torch.ops.lookup import n_iters_for
from w2rap_contigger_tpu_torch.paths import pather as tpather

K = 60
L = 100


def _reads():
    """A linear genome with an inserted palindrome, plus a circular
    plasmid (a smooth cycle in the graph); reads tiled over both, a few
    with errors so paths hold gaps and several runs."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, size=2400).astype(np.uint8)
    half = g[1000:1040]
    g[1040:1080] = (3 - half)[::-1]  # 80-base palindrome
    plasmid = rng.integers(0, 4, size=400).astype(np.uint8)
    ring = np.concatenate([plasmid, plasmid[:L]])
    seqs = [g[s : s + L] for s in range(0, len(g) - L, 3)]
    seqs += [ring[s : s + L] for s in range(0, len(plasmid), 3)]
    bases = np.stack(seqs).astype(np.uint8)
    noisy = rng.random(len(bases)) < 0.1
    pos = rng.integers(0, L, size=len(bases))
    bases[noisy, pos[noisy]] = (bases[noisy, pos[noisy]] + 1) % 4
    n = len(bases)
    return ReadSet(bases, np.full(n, L, np.int32), np.full((n, L), 35, np.uint8))


@pytest.fixture(scope="module")
def built():
    reads = _reads()
    jd, _ = ke.count_kmers(reads.bases, reads.lengths, reads.quals, K,
                           min_freq=2)
    raw = (jd.words.copy(), jd.counts.copy(), jd.ctx.astype(np.uint32).copy())
    d = state.dict_from_reference(*raw, K, "cpu")
    gb.recompute_adjacencies(jd)
    tgb.recompute_adjacencies(d)
    jeb, jes = gb.build_unitigs(jd)
    eb, es = tgb.build_unitigs(d)
    jhbv = gb.build_hbv_from_edges(jeb, jes, K)
    hbv = tgb.build_hbv_from_edges(eb, es, K)
    return dict(reads=reads, raw=raw, jd=jd, d=d, jedges=(jeb, jes),
                edges=(eb, es), jhbv=jhbv, hbv=hbv)


def test_adjacencies_match(built):
    words, _, ctx = built["raw"]
    M = words.shape[0]
    want = gb._recompute_adjacencies_dev(
        jnp.asarray(words), jnp.asarray(ctx), K, n_iters_for(M)
    )
    got = built["d"].ctx.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, built["jd"].ctx)
    assert (got != ctx).any()  # some context bits were pruned


def test_links_and_list_rank_match(built):
    d = built["d"]
    M = d.size
    words = d.host("words")
    ctx = d.host("ctx")
    want = np.asarray(gb._build_links_dev(
        jnp.asarray(words), jnp.asarray(ctx), K, n_iters_for(M)))
    nxt = tgb.build_links(d.words, d.ctx, K, n_iters_for(M))
    np.testing.assert_array_equal(nxt.numpy(), want)
    iters = tgb.rank_iters_for(M)
    jh, jr, jc = gb._list_rank_dev(jnp.asarray(want), iters)
    h, r, c = tgb.list_rank(nxt, iters)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert c.any() and (~c).any()  # the plasmid cycle + linear chains


def test_unitigs_and_hbv_match(built):
    d, jd = built["d"], built["jd"]
    for a, b in zip(built["edges"], built["jedges"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d.edge_id, jd.edge_id)
    np.testing.assert_array_equal(d.edge_offset, jd.edge_offset)
    np.testing.assert_array_equal(d.edge_rc, jd.edge_rc)
    (hbv, fx, rx), (jhbv, jfx, jrx) = built["hbv"], built["jhbv"]
    np.testing.assert_array_equal(fx, jfx)
    np.testing.assert_array_equal(rx, jrx)
    for name in ("edge_bases", "edge_start", "to_left", "to_right", "inv"):
        np.testing.assert_array_equal(getattr(hbv, name), getattr(jhbv, name))
    assert hbv.n_vertices == jhbv.n_vertices and hbv.n_edges > 2
    assert bk.is_palindrome(d.words, K).any()


def _pather_inputs(built):
    d, jd = built["d"], built["jd"]
    hbv, fx, rx = built["hbv"]
    ekm = (np.diff(hbv.edge_start) - K + 1)[fx].astype(np.int32)
    return d, jd, hbv, fx, rx, ekm


def test_lookup_compact_matches(built):
    d, jd, hbv, fx, rx, ekm = _pather_inputs(built)
    reads = built["reads"]
    packed = tpather.pack_rows_host(reads.bases)
    n_iters = n_iters_for(d.size)
    want = jpather._lookup_compact_chunk(
        jnp.asarray(packed), jnp.asarray(reads.lengths),
        jnp.asarray(jd.words).T, jnp.asarray(jd.edge_id),
        jnp.asarray(jd.edge_offset), jnp.asarray(jd.edge_rc),
        jnp.asarray(fx), jnp.asarray(rx), jnp.asarray(ekm), K, n_iters, L,
    )
    got = tpather.lookup_compact(
        bk.from_raw32(torch.from_numpy(packed.view(np.int32))),
        torch.from_numpy(reads.lengths.astype(np.int64)), d.table_t(),
        *d.kdef, torch.from_numpy(fx.astype(np.int64)),
        torch.from_numpy(rx.astype(np.int64)),
        torch.from_numpy(ekm.astype(np.int64)), K, n_iters, L,
    )
    nruns = got[4].numpy()
    np.testing.assert_array_equal(nruns, np.asarray(want[4]))
    assert nruns.max() > 1
    # slots past a read's run count hold arbitrary zero-key positions
    used = np.arange(got[0].shape[1])[None, :] < nruns[:, None]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy()[used], np.asarray(w)[used])


@pytest.mark.parametrize("slots", [tpather.RUN_SLOTS, 1])
def test_path_reads_match(built, monkeypatch, slots):
    """slots=1: every chunk holding a read with 2+ runs takes the dense
    fallback (lookup_core + _decode_chunk)."""
    d, jd, hbv, fx, rx, _ = _pather_inputs(built)
    reads = built["reads"]
    monkeypatch.setattr(tpather, "RUN_SLOTS", slots)
    dense = []
    decode_chunk = tpather._decode_chunk
    monkeypatch.setattr(tpather, "_decode_chunk",
                        lambda *a: dense.append(1) or decode_chunk(*a))
    want = jpather.path_reads(reads, jd, hbv, fx, rx, chunk_reads=256)
    got = tpather.path_reads(reads, d, hbv, fx, rx, chunk_reads=256)
    assert (len(dense) > 0) == (slots == 1)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.start, want.start)
    assert len(got.edges) > 0


def _large_k_pieces(seed=5, n=3000, piece=1500, step=100):
    """15 overlapping 1.5 kb pieces of one random 3 kb sequence (a blob's
    corrected reads, as step 5 hands them to its local graph)."""
    seq = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    pieces = [seq[s:s + piece] for s in range(0, n - piece + 1, step)]
    seg = np.zeros(len(pieces) + 1, dtype=np.int64)
    seg[1:] = np.cumsum([len(p) for p in pieces])
    return np.concatenate(pieces), seg


@pytest.mark.parametrize("k", [544, 640])
def test_host_leaf_graph_matches_torch_at_large_k(k):
    """Above k = 512 the host graph leaf (native/graph_kernel.cc) must
    build the torch route's graph: one unitig over the 3 kb sequence.
    The JAX package's leaf overruns its stack arrays there, so the
    port's torch route is the oracle."""
    from w2rap_contigger_tpu_torch.ops import kmer_engine as tke

    assert tgb._native_graph_lib() is not None
    flat, seg = _large_k_pieces()
    hd = tke.count_kmers_flat(flat, seg, k, min_freq=2, host=True)
    tgb.recompute_adjacencies(hd, host=True)
    heb, hes = tgb.build_unitigs(hd, host=True)
    d = tke.count_kmers_flat(flat, seg, k, min_freq=2, device="cpu")
    tgb.recompute_adjacencies(d)
    eb, es = tgb.build_unitigs(d)
    assert hd.size == d.size > 0
    np.testing.assert_array_equal(hd.words, d.words.numpy().astype(np.uint32))
    np.testing.assert_array_equal(hd.ctx, d.ctx.numpy().astype(np.uint32))
    np.testing.assert_array_equal(hes, es)
    np.testing.assert_array_equal(heb, eb)
    assert len(es) == 2  # one unitig


def test_host_leaf_refuses_rows_above_its_size():
    lib = tgb._native_graph_lib()
    assert lib is not None
    W = tgb.NATIVE_MAX_W + 1
    words = np.zeros((4, W), np.uint32)
    ctx = np.zeros(4, np.uint32)
    with pytest.raises(ValueError, match="at most 40 words"):
        tgb._build_links_native(lib, words, ctx, 16 * W)
    d = SimpleNamespace(words=words, ctx=ctx, size=4, k=16 * W)
    with pytest.raises(ValueError, match="at most 40 words"):
        tgb._prune_ctx_native(lib, d)
    assert not d.ctx.any()
