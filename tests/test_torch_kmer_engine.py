"""Device counting (K1 -> torch sort -> K2 -> compaction) of the port on
the CPU against the JAX package's count_kmers_device with its Pallas
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
