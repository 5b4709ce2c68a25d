"""Step 5a, the correction stack: the port's trim_reads, fill_pairs and
correction_suite on the CPU against the JAX package's on the same reads,
and the host routes that blob-local graphs take (the native count,
adjacency, unitig and pathing leaves, and the numpy fallbacks of the
graph and flat-pathing leaves) against the port's torch routes on the
same dictionary.  Tolerance: exact equality."""

import numpy as np
import pytest

from w2rap_contigger_tpu.core import dna
from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.ops import correction as jcorr
from w2rap_contigger_tpu.paths import fillpairs as jfill
from w2rap_contigger_tpu_torch import native
from w2rap_contigger_tpu_torch.core.reads import ReadSet as TReadSet
from w2rap_contigger_tpu_torch.graph import build as gb
from w2rap_contigger_tpu_torch.ops import correction as tcorr
from w2rap_contigger_tpu_torch.ops import kmer_engine as ke
from w2rap_contigger_tpu_torch.ops import precorrect as tpc
from w2rap_contigger_tpu_torch.paths import fillpairs as tfill
from w2rap_contigger_tpu_torch.paths import flat_pather, pather


def _port(reads):
    return TReadSet(reads.bases, reads.lengths, reads.quals)


def _pairs(rng, glen, rlen, insert, step, err=0.0):
    """Interleaved pairs tiling a random genome; errors (a fraction err of
    bases) get quality 8 or 30 at random."""
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    seqs, quals = [], []
    for s in range(0, glen - insert, step):
        frag = genome[s : s + insert]
        for r in (frag[:rlen].copy(), dna.revcomp_codes(frag[-rlen:]).copy()):
            q = np.full(rlen, 38 if err == 0 else 36, np.uint8)
            m = rng.random(rlen) < err
            r[m] = (r[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
            q[m] = np.where(rng.random(int(m.sum())) < 0.5, 8, 30)
            seqs.append(r)
            quals.append(q)
    return ReadSet.from_sequences(seqs, quals)


def test_trim_reads_and_fill_pairs_match_jax(rng):
    """tests/test_fillpairs.py's data: 80 bp pairs, insert 300, on a 3 kb
    genome; and 150 bp reads with one error read for the trim."""
    reads = _pairs(rng, 3000, 80, 300, 5)
    jf, jn = jfill.fill_pairs(reads, min_freq=3)
    tf, tn = tfill.fill_pairs(_port(reads), min_freq=3)
    assert tn == jn and tn > 0
    assert len(tf) == len(jf)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b, a)

    genome = rng.integers(0, 4, size=2000).astype(np.uint8)
    seqs = [genome[s : s + 150] for s in range(0, 2000 - 150, 3)]
    bad = genome[300:450].copy()
    bad[100] = (bad[100] + 1) % 4
    reads = ReadSet.from_sequences(seqs + [bad])
    trim = tfill.trim_reads(_port(reads), min_freq=3)
    np.testing.assert_array_equal(trim, jfill.trim_reads(reads, min_freq=3))
    assert int(trim[-1]) == 100


def test_correction_suite_matches_jax(monkeypatch):
    """A blob-sized pair set (125 pairs, 100 bp, insert 250, 1% errors):
    pre-correction fixes bases and the K2=80 graph closes pairs that
    FillPairs left open, then every output equals the JAX package's."""
    reads = _pairs(np.random.default_rng(4), 1000, 100, 250, 6, err=0.01)
    seen = {}
    pre_correct = tpc.pre_correct
    close_pairs = tcorr._close_pairs_k2

    def counted_pre_correct(*a, **kw):
        out = pre_correct(*a, **kw)
        seen["fixed"] = out[1]
        return out

    def counted_close_pairs(creads, cquals, lens, trim_to, done, *a, **kw):
        before = int(done.sum())
        out = close_pairs(creads, cquals, lens, trim_to, done, *a, **kw)
        seen["closed"] = int(out[2].sum()) - before
        return out

    monkeypatch.setattr(tpc, "pre_correct", counted_pre_correct)
    monkeypatch.setattr(tcorr, "_close_pairs_k2", counted_close_pairs)
    got = tcorr.correction_suite(_port(reads), device="cpu")
    want = jcorr.correction_suite(reads)
    assert seen["fixed"] > 0 and seen["closed"] > 0
    corrected, creads, cquals, done = got
    assert len(corrected) == len(want[0])
    for a, b in zip(want[0], corrected):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for a, b in zip(want[1:], (creads, cquals, done)):
        np.testing.assert_array_equal(b, a)


def _flat(reads):
    seg = np.zeros(reads.n_reads + 1, dtype=np.int64)
    seg[1:] = np.cumsum(reads.lengths)
    flat = np.concatenate([reads.bases[i, : reads.lengths[i]] for i in range(reads.n_reads)])
    return flat, seg


def _host_graph(flat, seg, k):
    hd = ke.count_kmers_flat(flat, seg, k, host=True)
    gb.recompute_adjacencies(hd, host=True)
    eb, es = gb.build_unitigs(hd, host=True)
    return hd, eb, es


@pytest.mark.parametrize("k", [60, 200])
def test_host_routes_match_torch_routes(k, monkeypatch):
    """Count, adjacencies, unitigs (with KDef planes), flat pathing and
    read pathing: the host routes on a HostKmerDict equal the torch
    routes on the CPU dict of the same sequences; so do the numpy
    fallbacks of the graph and flat-pathing leaves."""
    reads = _pairs(np.random.default_rng(k), 1500, 250, 400, 7, err=0.004)
    flat, seg = _flat(reads)
    hd = ke.count_kmers_flat(flat, seg, k, host=True)
    td = ke.count_kmers_flat(flat, seg, k, device="cpu")
    assert isinstance(hd, ke.HostKmerDict) and hd.size == td.size > 0
    np.testing.assert_array_equal(hd.words, td.host("words"))
    np.testing.assert_array_equal(hd.ctx, td.host("ctx"))
    np.testing.assert_array_equal(hd.counts, td.host("counts"))

    gb.recompute_adjacencies(hd, host=True)
    gb.recompute_adjacencies(td)
    np.testing.assert_array_equal(hd.ctx, td.host("ctx"))
    heb, hes = gb.build_unitigs(hd)
    teb, tes = gb.build_unitigs(td)
    np.testing.assert_array_equal(heb, teb)
    np.testing.assert_array_equal(hes, tes)
    for plane in ("edge_id", "edge_offset", "edge_rc"):
        np.testing.assert_array_equal(getattr(hd, plane), getattr(td, plane))

    hbv, fx, rx = gb.build_hbv_from_edges(heb, hes, k)
    assert hbv.n_edges > 2
    hp = flat_pather.path_flat_sequences(flat, seg, hd, hbv, fx, rx, host=True)
    tp = flat_pather.path_flat_sequences(flat, seg, td, hbv, fx, rx)
    for a, b in zip(hp[0], tp[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hp[1], tp[1])
    np.testing.assert_array_equal(hp[2], tp[2])
    hr = pather.path_reads(_port(reads), hd, hbv, fx, rx)
    tr = pather.path_reads(_port(reads), td, hbv, fx, rx)
    for f in ("offsets", "edges", "start"):
        np.testing.assert_array_equal(getattr(hr, f), getattr(tr, f))

    # the numpy fallbacks of the graph and flat-pathing leaves
    monkeypatch.setattr(gb, "_native_graph_lib", lambda: None)
    monkeypatch.setattr(flat_pather, "_native_path_lib", lambda: None)
    nd, neb, nes = _host_graph(flat, seg, k)
    np.testing.assert_array_equal(nd.ctx, hd.ctx)
    np.testing.assert_array_equal(neb, heb)
    np.testing.assert_array_equal(nes, hes)
    for plane in ("edge_id", "edge_offset", "edge_rc"):
        np.testing.assert_array_equal(getattr(nd, plane), getattr(hd, plane))
    npth = flat_pather.path_flat_sequences(flat, seg, nd, hbv, fx, rx, host=True)
    for a, b in zip(npth[0], hp[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(npth[1], hp[1])
    np.testing.assert_array_equal(npth[2], hp[2])


def test_host_routes_refuse_a_device_dict_and_a_missing_leaf(monkeypatch):
    """The host routes take only host dicts; with no C++ toolchain the
    blob count and the read pather raise instead of falling back."""
    reads = _pairs(np.random.default_rng(3), 1200, 100, 250, 9)
    flat, seg = _flat(reads)
    td = ke.count_kmers_flat(flat, seg, 60, device="cpu")
    with pytest.raises(TypeError, match="HostKmerDict"):
        gb.recompute_adjacencies(td, host=True)
    hd, eb, es = _host_graph(flat, seg, 60)
    hbv, fx, rx = gb.build_hbv_from_edges(eb, es, 60)
    monkeypatch.setattr(native, "load", lambda *a, **kw: None)
    with pytest.raises(RuntimeError, match="count_kernel.cc"):
        ke.count_kmers_flat(flat, seg, 60, host=True)
    with pytest.raises(RuntimeError, match="path_kernel.cc"):
        pather.path_reads(_port(reads), hd, hbv, fx, rx)
