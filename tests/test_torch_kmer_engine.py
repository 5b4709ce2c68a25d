"""Device counting (K1 -> sort -> K2 -> compaction) of the port on
the CPU, under each sort back end, against the JAX package's count_kmers_device with its Pallas
kernels in interpret mode: dictionary words, counts, contexts and the
101-bin histogram.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from w2rap_contigger_tpu_torch import state


def _reads(rng, k):
    """Reads tiled over a short genome (counts well above min_freq and
    past 255 for a repeated block), with sequencing errors and low-quality
    bases."""
    genome = rng.integers(0, 4, size=1500).astype(np.uint8)
    L = 100
    starts = np.concatenate([rng.integers(0, len(genome) - L, size=300),
                             np.full(260, 7)])
    bases = np.stack([genome[s : s + L] for s in starts]).astype(np.uint8)
    err = rng.random(bases.shape) < 0.004
    bases[err] = (bases[err] + 1) % 4
    lengths = rng.integers(k - 5, L + 1, size=len(starts)).astype(np.int32)
    quals = np.full(bases.shape, 35, np.uint8)
    quals[rng.random(bases.shape) < 0.01] = 2
    # the repeated block: clean full-length copies, counts saturate at 255
    bases[300:] = genome[7 : 7 + L]
    lengths[300:] = L
    quals[300:] = 35
    return bases, lengths, quals


@pytest.mark.parametrize("k,min_freq", [(60, 4), (48, 2)])
def test_count_matches_jax_device_count(rng, k, min_freq):
    """k=60: ctx rides in the pad bits; k=48: odd W=3 with no pad bits,
    so the payload travels as its own plane through the sort."""
    bases, lengths, quals = _reads(rng, k)
    jd, jhist = ke.count_kmers_device(
        bases, lengths, quals, k, min_qual=7, min_freq=min_freq,
        chunk_reads=128, interpret=True,
    )
    d, hist = tke.count_kmers_batched(
        bases, lengths, quals, k, min_qual=7, min_freq=min_freq,
        chunk_reads=96, device="cpu",
    )
    words, counts, ctx = state.dict_to_numpy(d)
    assert d.size == jd.size > 0
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
    np.testing.assert_array_equal(hist, jhist)
    assert counts.max() == 255 and hist[1:min_freq].sum() > 0


def test_dict_state_round_trip(rng):
    words = np.sort(rng.integers(0, 1 << 32, size=(50, 4), dtype=np.uint64), axis=0)
    words = words.astype(np.uint32)
    counts = rng.integers(1, 256, size=50).astype(np.int32)
    ctx = rng.integers(0, 256, size=50).astype(np.uint32)
    d = state.dict_from_reference(words, counts, ctx, 60, "cpu")
    assert d.words.dtype == torch.int64 and d.size == 50
    for a, b in zip(state.dict_to_numpy(d), (words, counts, ctx)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_batched_counting_raises_not_implemented(rng):
    bases, lengths, quals = _reads(rng, 60)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tke.count_kmers_batched(bases, lengths, quals, 60, disk_batches=2,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tke.count_kmers_batched(bases, lengths, quals, 60, max_mem_gb=0,
                                device="cpu")


def test_short_reads_give_empty_dict(rng):
    bases = rng.integers(0, 4, size=(8, 50)).astype(np.uint8)
    d, hist = tke.count_kmers_device(
        bases, np.full(8, 50, np.int32), np.full((8, 50), 35, np.uint8), 60,
        device="cpu",
    )
    assert d.size == 0 and hist.sum() == 0


@pytest.fixture(scope="module")
def sort_cases():
    return {}


def _sort_case(cases, k):
    """Reads for the sort back-end tests at k, and the JAX package's
    count of them (its Pallas kernels in interpret mode), made once per
    k for both back ends: 512 reads of 100 bases (101 - k windows a read:
    20992 to 40960 rows), with errors and low-quality bases, no block
    repeated past a radix slot.  The read length and chunk are those of
    test_count_matches_jax_device_count, so at k=60 the JAX kmerize
    program compiles once for both."""
    if k not in cases:
        rng = np.random.default_rng(1234 + k)
        L = 100
        genome = rng.integers(0, 4, size=3000).astype(np.uint8)
        starts = rng.integers(0, len(genome) - L, size=512)
        bases = np.stack([genome[s : s + L] for s in starts])
        err = rng.random(bases.shape) < 0.004
        bases[err] = (bases[err] + 1) % 4
        lengths = np.full(len(starts), L, np.int32)
        quals = np.full(bases.shape, 35, np.uint8)
        quals[rng.random(bases.shape) < 0.002] = 2
        jd, jhist = ke.count_kmers_device(bases, lengths, quals, k, min_freq=2,
                                          chunk_reads=128, interpret=True)
        cases[k] = (bases, lengths, quals, jd, jhist)
    return cases[k]


@pytest.mark.parametrize("k", [21, 31, 60])
def test_radix_backend_matches_jax_lax(sort_cases, monkeypatch, k):
    """W2RAP_SORT=radix (K4 through its plain version, the tile shrunk as
    tests/test_kmer_engine.py:259-261 shrink JAX's) against the JAX
    package's count: dictionary and histogram."""
    from w2rap_contigger_tpu_torch.ops import radix

    bases, lengths, quals, jd, jhist = _sort_case(sort_cases, k)
    # 4096-row tiles, 8 bins of ~512 rows: under the 896-row overflow
    # threshold (2048-row tiles have 4 bins of ~512, 1024-row tiles 2
    # bins: JAX's halving rule keeps slots at 1024 rows)
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 32)
    monkeypatch.setattr(radix, "DEFAULT_REGION_ROWS", 64)
    monkeypatch.setenv("W2RAP_SORT", "radix")
    recounts = tke.RADIX_RECOUNTS
    d, hist = tke.count_kmers_device(bases, lengths, quals, k, min_freq=2,
                                     chunk_reads=256, device="cpu")
    assert tke.RADIX_RECOUNTS == recounts
    words, counts, ctx = state.dict_to_numpy(d)
    assert d.size == jd.size > 0
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
    np.testing.assert_array_equal(hist, jhist)


def test_radix_recounts_exactly_on_overflow(rng, monkeypatch):
    """A kmer with more copies than a slot holds (poly-A reads) overflows
    the partition sort, which falls back to the exact lax sort: the same
    dictionary and histogram, one recount."""
    from w2rap_contigger_tpu_torch.ops import radix

    bases, lengths, quals = _reads(rng, 60)
    bases[300:] = 0
    want, whist = tke.count_kmers_device(bases, lengths, quals, 60, device="cpu")
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 16)
    monkeypatch.setenv("W2RAP_SORT", "radix")
    recounts = tke.RADIX_RECOUNTS
    d, hist = tke.count_kmers_device(bases, lengths, quals, 60, device="cpu")
    assert tke.RADIX_RECOUNTS == recounts + 1
    assert torch.equal(d.words, want.words) and torch.equal(d.cnt, want.cnt)
    assert np.array_equal(hist, whist)
    # the bitonic sort is exact on all words: the same counts, no recount
    monkeypatch.setenv("W2RAP_SORT", "pallas")
    d, hist = tke.count_kmers_device(bases, lengths, quals, 60, device="cpu")
    assert tke.RADIX_RECOUNTS == recounts + 1
    assert torch.equal(d.words, want.words) and torch.equal(d.cnt, want.cnt)
    assert torch.equal(d.ctx, want.ctx) and np.array_equal(hist, whist)


@pytest.mark.parametrize("k", [21, 31, 60])
def test_pallas_backend_matches_jax(sort_cases, monkeypatch, k):
    """W2RAP_SORT=pallas (K3 through its plain version: W word planes +
    the payload plane, padded to the next power of two) against the JAX
    package's count_kmers_device: dictionary and histogram.  k=21 and 31
    have one or two pad bits' worth of words (W=2), k=60 W=4."""
    bases, lengths, quals, jd, jhist = _sort_case(sort_cases, k)
    monkeypatch.setenv("W2RAP_SORT", "pallas")
    d, hist = tke.count_kmers_device(bases, lengths, quals, k, min_freq=2,
                                     chunk_reads=96, device="cpu")
    words, counts, ctx = state.dict_to_numpy(d)
    assert d.size == jd.size > 0 and hist[1] > 0
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
    np.testing.assert_array_equal(hist, jhist)


@pytest.mark.parametrize("k,sort", [(200, "lax"), (260, "lax"), (260, "radix"),
                                    (260, "pallas")])
def test_count_kmers_flat_matches_jax(rng, monkeypatch, k, sort):
    """Step 3's flat counting against the JAX package's count_kmers_flat:
    segments of a genome (shared kmers across segments) and random ones,
    some shorter than k."""
    from w2rap_contigger_tpu_torch.ops import radix

    genome = rng.integers(0, 4, size=6000).astype(np.uint8)
    seqs = [genome[s : s + int(n)] for s, n in
            zip(rng.integers(0, 3000, size=20), rng.integers(150, 3000, size=20))]
    seqs += [rng.integers(0, 4, size=int(n)).astype(np.uint8)
             for n in rng.integers(100, 900, size=6)]
    seg = np.zeros(len(seqs) + 1, dtype=np.int64)
    seg[1:] = np.cumsum([len(s) for s in seqs])
    flat = np.concatenate(seqs)
    jd = ke.count_kmers_flat(flat, seg, k, min_freq=1, device_pipeline=False)
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 32)
    monkeypatch.setenv("W2RAP_SORT", sort)
    recounts = tke.RADIX_RECOUNTS
    d = tke.count_kmers_flat(flat, seg, k, min_freq=1, chunk_pos=4096, device="cpu")
    assert tke.RADIX_RECOUNTS == recounts
    words, counts, ctx = state.dict_to_numpy(d)
    assert d.size == jd.size > 0 and counts.max() > 1
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
