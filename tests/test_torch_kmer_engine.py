"""Device counting (K1 -> sort -> K2 -> compaction) of the port on
the CPU, under each sort back end, against the JAX package's count_kmers_device with its Pallas
kernels in interpret mode, and range-batched counting (-d, -m,
--tmp_dir) against the JAX package's count_kmers_batched: dictionary
words, counts, contexts and the 101-bin histogram.  Tolerance: exact
equality."""

import os

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


@pytest.fixture(scope="module")
def batch_case():
    """Reads for the range-batched tests (1024 reads of 100 bases over a
    4 kb genome, with errors: 42k k=60 rows, the 4 ranges of -d 4 holding
    18k, 13k, 7.7k and 2.6k), and the JAX package's unbatched count of
    them (on the CPU its native spill)."""
    rng = np.random.default_rng(7)
    L = 100
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, size=1024)
    bases = np.stack([genome[s : s + L] for s in starts])
    err = rng.random(bases.shape) < 0.004
    bases[err] = (bases[err] + 1) % 4
    lengths = np.full(len(starts), L, np.int32)
    quals = np.full(bases.shape, 35, np.uint8)
    quals[rng.random(bases.shape) < 0.002] = 2
    return bases, lengths, quals, ke.count_kmers_batched(bases, lengths, quals, 60,
                                                         min_freq=2)


def _assert_dict(d, hist, jd, jhist):
    words, counts, ctx = state.dict_to_numpy(d)
    assert d.size == jd.size > 0
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
    np.testing.assert_array_equal(hist, jhist)


# case -> (-d, -m, W2RAP_SORT, ranges): -m 0 forces 256 ranges; at -m 2
# MiB the JAX package's rule takes 2 ranges (2.5 MB estimated), but the
# first of them holds 31k rows (2.5 MB at count_row_bytes), so the port
# takes 4, whose largest (18k rows) fits
BATCH_CASES = {"d2": (2, 10000, "lax", 2), "d4": (4, 10000, "lax", 4),
               "d8": (8, 10000, "lax", 8), "m0": (0, 0, "lax", 256),
               "m_ceiling": (0, 2.0 ** -9, "lax", 4),
               "d4_radix": (4, 10000, "radix", 4), "d4_pallas": (4, 10000, "pallas", 4)}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batched_count_matches_jax(batch_case, monkeypatch, case):
    """Range batching (-d, -m) under each sort back end: one pass a hash
    range, the ranges concatenated, against the JAX package's batched
    count (its native spill on the CPU) and its unbatched count; every
    range of -d 2/4/8 holds kmers (those >= R/2 need the top bits of word
    0 taken unsigned)."""
    from w2rap_contigger_tpu_torch.ops import radix

    disk_batches, max_mem, sort, R = BATCH_CASES[case]
    bases, lengths, quals, (jd0, jh0) = batch_case
    jd, jh = ke.count_kmers_batched(bases, lengths, quals, 60, min_freq=2,
                                    disk_batches=disk_batches, max_mem_gb=max_mem)
    # 2048-row tiles: ranges 0 and 1 take the partition sort, 2 and 3 lax
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 16)
    monkeypatch.setattr(radix, "DEFAULT_REGION_ROWS", 64)
    monkeypatch.setenv("W2RAP_SORT", sort)
    passes, sorts = [], []
    count_chunks, partition_sort = tke._count_chunks, radix.partition_sort
    monkeypatch.setattr(tke, "_count_chunks", lambda *a, **kw: passes.append(a[1])
                        or count_chunks(*a, **kw))
    monkeypatch.setattr(radix, "partition_sort", lambda p, *a, **kw: sorts.append(p.shape[1])
                        or partition_sort(p, *a, **kw))
    recounts = tke.RADIX_RECOUNTS
    d, hist = tke.count_kmers_batched(bases, lengths, quals, 60, min_freq=2,
                                      chunk_reads=256, disk_batches=disk_batches,
                                      max_mem_gb=max_mem, device="cpu")
    _assert_dict(d, hist, jd, jh)
    _assert_dict(d, hist, jd0, jh0)
    assert len(passes) == R and tke.RADIX_RECOUNTS == recounts
    assert len(sorts) == (2 if sort == "radix" else 0)
    rb = R.bit_length() - 1
    top = d.host("words")[:, 0] >> np.uint32(32 - rb)
    if R <= 8:
        assert set(top.tolist()) == set(range(R))
    assert (top >= R // 2).sum() > 0


def test_batched_spill_leaves_no_file(batch_case, monkeypatch, tmp_path):
    """-d 4 --tmp_dir: each range's dict goes through its npz file, which
    is gone afterwards; the dict is the unbatched one."""
    bases, lengths, quals, (jd0, jh0) = batch_case
    spill = tmp_path / "spill"
    saved = []
    savez = tke.np.savez
    monkeypatch.setattr(tke.np, "savez", lambda path, **kw: saved.append(path)
                        or savez(path, **kw))
    d, hist = tke.count_kmers_batched(bases, lengths, quals, 60, min_freq=2,
                                      chunk_reads=256, disk_batches=4,
                                      tmp_dir=str(spill), device="cpu")
    _assert_dict(d, hist, jd0, jh0)
    assert [os.path.basename(p) for p in saved] == [
        f"kmer_range_{ri:04d}.npz" for ri in range(4)]
    assert os.listdir(spill) == []


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
