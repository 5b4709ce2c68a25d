"""K0 (csrc/pack.cu, `kmerize.pack_glen`): the 2-bit pack and usable
lengths of raw reads on the card, and the count's chunks through it
(`kmer_engine._device_chunks`).  Tolerance: exact equality.

On the CPU: a model of the kernel's arithmetic, lane by lane (its
aligned loads, byte pack, SIMD quality compare, warp scan of the last
bad bases and shift-and of each word's mask) against the plain version, the host
route of `_device_chunks`, and the wrapper's checks.  On a card (`cuda`):
the kernel against the plain version and `pack_and_glen_host` on the same
cases and on one 65,536 x 250 chunk, and `_device_chunks` against its host
route, one K0 launch a chunk, and `path_reads` on a card dictionary
against the CPU route, one K0 launch a pathing chunk.  The file imports
no JAX, so the `cuda` tests run on a card alone (`python -m pytest
--noconftest tests/test_torch_pack.py`)."""

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.core.reads import ReadSet
from w2rap_contigger_tpu_torch.graph import build as tgb
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from w2rap_contigger_tpu_torch.ops import kmerize as kkm
from w2rap_contigger_tpu_torch.paths import pather as tpather
from _torch_guards import time_limited  # noqa: F401
import _pack_cases as pc

FULL = 0xFFFFFFFF


def _clz(x: int) -> int:
    return 32 - int(x).bit_length()


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def _pack4(x: int) -> int:
    """csrc/pack.cu pack4: byte permute, shift, or, masks."""
    x &= 0x03030303
    y = int.from_bytes(x.to_bytes(4, "little"), "big")  # __byte_perm(x, 0, 0x0123)
    y |= y >> 6
    return (y & 0xF) | ((y >> 12) & 0xF0)


def _good4(q: int, mq: int) -> int:
    """csrc/pack.cu good4: __vcmpgeu4, then the multiply that gathers a
    bit a byte."""
    ge = sum(0xFF << (8 * i) for i in range(4) if (q >> (8 * i)) & 0xFF >= mq)
    return (((ge & 0x01010101) * 0x10204080) & FULL) >> 28


def _load16(flat: bytes, off: int):
    """csrc/pack.cu load16 on a flat array whose first byte is 4-aligned:
    the 5 aligned words from off & ~3 (0 at or past the end), shifted."""
    a, sh = off & ~3, 8 * (off & 3)
    x = [int.from_bytes(flat[a + 4 * i: a + 4 * i + 4].ljust(4, b"\0"), "little")
         if a + 4 * i < len(flat) else 0 for i in range(5)]
    return [((x[i + 1] << 32 | x[i]) >> sh) & FULL for i in range(4)]


def _k0_model(bases, quals, lengths, k: int, min_qual: int):
    """K0 as csrc/pack.cu computes it, in Python, lane by lane: a thread
    an output word, a warp 32 // wr rows (or one row in turns of 32
    words); the warp's inclusive max scan of each word's last bad
    position, the row's start counting as bad; each word's candidate from
    its leading run plus the run entering it, or the shift-and of its
    mask for k <= 16; a max over the row's lanes."""
    n, L = bases.shape
    wr = (L + 15) // 16
    packed = np.zeros((n, wr), dtype=np.uint32)
    glen = np.zeros(n, dtype=np.int32)
    fb, fq = bases.tobytes(), quals.tobytes()
    mq4 = min(max(min_qual, 0), 255)
    rpw = 32 // wr if wr <= 32 else 1
    turns = 1 if wr <= 32 else -(-wr // 32)
    for warp in range(-(-n // rpw)):
        ri = [lane // wr if wr <= 32 else 0 for lane in range(32)]
        rows = [warp * rpw + ri[lane] for lane in range(32)]
        row_ok = [ri[lane] < rpw and rows[lane] < n for lane in range(32)]
        row0 = [16 * ri[lane] * wr for lane in range(32)]
        carry, best = -1, [0] * 32
        for t in range(turns):
            last, cand, good_of, base_of, ok_of = [], [], [], [], []
            for lane in range(32):
                w = lane - ri[lane] * wr if wr <= 32 else 32 * t + lane
                ok = row_ok[lane] and w < wr
                base = 16 * (lane if wr <= 32 else 32 * t + lane)
                good = 0
                if ok:
                    r = rows[lane]
                    c = _load16(fb, r * L + 16 * w)
                    q = _load16(fq, r * L + 16 * w)
                    word = _pack4(c[0]) << 24 | _pack4(c[1]) << 16 | _pack4(c[2]) << 8 | _pack4(c[3])
                    good = sum(_good4(q[i], mq4) << (4 * i) for i in range(4))
                    if min_qual <= 0:
                        good = 0xFFFF
                    if min_qual > 255:
                        good = 0
                    length = min(int(lengths[r]), L)
                    good &= (1 << min(max(length - 16 * w, 0), 16)) - 1
                    word &= (FULL << (2 * (16 - min(L - 16 * w, 16)))) & FULL
                    packed[r, w] = word
                bad = ~good & 0xFFFF
                last.append(base + 31 - _clz(bad) if ok and bad else -1)
                good_of.append(good)
                base_of.append(base)
                ok_of.append(ok)
            incl = list(np.maximum.accumulate(last))
            for lane in range(32):
                before = max(incl[lane - 1] if lane else -1, carry, row0[lane] - 1)
                value = 0
                if ok_of[lane]:
                    base, good = base_of[lane], good_of[lane]
                    bad = ~good & 0xFFFF
                    run_in = base - 1 - before
                    lead = _ffs(bad) - 1 if bad else 16
                    if run_in + lead >= k:
                        value = base + lead - row0[lane]
                    if k <= 16:
                        m, have = good, 1
                        while 2 * have <= k:
                            m &= m << have
                            have *= 2
                        if have < k:
                            m &= m << (k - have)
                        if m:
                            value = max(value, base + 32 - _clz(m) - row0[lane])
                cand.append(value)
            carry = max(carry, incl[31])
            for lane in range(32):
                group = [j for j in range(32) if ri[j] == ri[lane]] if row_ok[lane] else [lane]
                best[lane] = max(best[lane], max(cand[j] for j in group))
        for lane in range(32):
            if row_ok[lane] and lane == ri[lane] * wr:
                glen[rows[lane]] = best[lane]
    return packed.view(np.int32), glen


@pytest.mark.parametrize("case", pc.CASE_IDS)
def test_k0_model_matches_plain(case):
    bases, quals, lengths, k, mq = pc.case(case)
    pr, glen = _k0_model(bases, quals, lengths, k, mq)
    got_pr, got_glen = kkm.pack_glen_plain(
        *map(torch.from_numpy, (bases, quals, lengths)), k, mq)
    np.testing.assert_array_equal(pr, got_pr.numpy())
    np.testing.assert_array_equal(glen, got_glen.numpy())


@pytest.mark.parametrize("min_qual", [0, 255, 256])
def test_k0_model_quality_limits(min_qual):
    """min_qual at and past the bytes' range: every base good, only
    q = 255, none."""
    bases, quals, lengths = pc.reads(3, 9, 37, 16)
    quals[:3] = 255
    pr, glen = _k0_model(bases, quals, lengths, 16, min_qual)
    got_pr, got_glen = kkm.pack_glen_plain(
        *map(torch.from_numpy, (bases, quals, lengths)), 16, min_qual)
    np.testing.assert_array_equal(pr, got_pr.numpy())
    np.testing.assert_array_equal(glen, got_glen.numpy())
    want_pr, want_glen = kkm.pack_and_glen_host(bases, quals, lengths, 16, min_qual)
    np.testing.assert_array_equal(glen, want_glen)


def test_pack_glen_checks_inputs():
    b = torch.zeros((4, 250), dtype=torch.uint8)
    ln = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kkm.pack_glen(b, b, ln.to(torch.int64), 60, 7)
    with pytest.raises(TypeError):
        kkm.pack_glen(b.to(torch.int32), b, ln, 60, 7)
    with pytest.raises(ValueError):
        kkm.pack_glen(b, b[:, :200], ln, 60, 7)
    with pytest.raises(ValueError):
        kkm.pack_glen(b, b, ln[:3], 60, 7)


def _chunks(bases, lengths, quals, dev, chunk_reads, stream=None):
    chunks = list(tke._device_chunks(bases, lengths, quals, 60, pc.MIN_QUAL, chunk_reads,
                                     dev, stream))
    tdev.synchronize(dev)  # K0 ran on `stream`; the copies below on the current one
    return [tuple(t.cpu().numpy() for t in c) for c in chunks]


def test_device_chunks_on_the_cpu_pack_on_the_host():
    """A CPU device takes the host pack, chunk by chunk: no K0 launch."""
    bases, quals, lengths = pc.reads(5, 250, 250, 60)
    before = tdev.LAUNCHES["pack"]
    got = _chunks(bases, lengths, quals, "cpu", 64)
    assert tdev.LAUNCHES["pack"] == before
    assert len(got) == 4
    for i, (pr, glen) in enumerate(got):
        sl = slice(64 * i, 64 * (i + 1))
        want_pr, want_glen = kkm.pack_and_glen_host(bases[sl], quals[sl], lengths[sl], 60,
                                                    pc.MIN_QUAL)
        np.testing.assert_array_equal(pr, want_pr.view(np.int32))
        np.testing.assert_array_equal(glen, want_glen)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K0 has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", pc.CASE_IDS)
def test_pack_kernel_matches_plain(case):
    _card()
    bases, quals, lengths, k, mq = pc.case(case)
    dev = [torch.from_numpy(a).cuda() for a in (bases, quals, lengths)]
    before = tdev.LAUNCHES["pack"]
    pr, glen = kkm.pack_glen(*dev, k, mq)
    assert tdev.LAUNCHES["pack"] == before + (len(lengths) > 0)
    want_pr, want_glen = kkm.pack_glen_plain(*dev, k, mq)
    assert torch.equal(pr, want_pr) and torch.equal(glen, want_glen)
    host_pr, host_glen = kkm.pack_and_glen_host(bases, quals, lengths, k, mq)
    np.testing.assert_array_equal(pr.cpu().numpy(), host_pr.view(np.int32))
    np.testing.assert_array_equal(glen.cpu().numpy(), host_glen)


@pytest.mark.cuda
def test_pack_kernel_full_chunk():
    """One chunk of the count's shape: 65,536 reads of 250 bases, 2% Q2."""
    _card()
    bases, quals, lengths = pc.synth_chunk(11)
    pr, glen = kkm.pack_glen(*(torch.from_numpy(a).cuda() for a in (bases, quals, lengths)),
                             60, pc.MIN_QUAL)
    host_pr, host_glen = kkm.pack_and_glen_host(bases, quals, lengths, 60, pc.MIN_QUAL)
    np.testing.assert_array_equal(pr.cpu().numpy(), host_pr.view(np.int32))
    np.testing.assert_array_equal(glen.cpu().numpy(), host_glen)
    assert (host_glen < 250).any() and (host_glen == 250).any()
    attrs = kkm.pack_attrs()
    assert attrs["local_bytes"] == 0 and attrs["max_threads"] >= 256


@pytest.mark.cuda
def test_device_chunks_on_the_card_match_the_host_route():
    """Four chunks, the last ragged, on the current stream and on a
    stream of their own (as a shard's): the host route's rows and glen,
    one K0 launch a chunk."""
    _card()
    bases, quals, lengths = pc.reads(7, 3 * 1000 + 17, 250, 60)
    want = _chunks(bases, lengths, quals, "cpu", 1000)
    for stream in (None, torch.cuda.Stream()):
        before = tdev.LAUNCHES["pack"]
        got = _chunks(bases, lengths, quals, "cuda", 1000, stream)
        assert tdev.LAUNCHES["pack"] == before + 4
        assert len(got) == len(want) == 4
        for (pr, glen), (want_pr, want_glen) in zip(got, want):
            np.testing.assert_array_equal(pr, want_pr)
            np.testing.assert_array_equal(glen, want_glen)


def _pathing_case():
    """Reads of 100 bases tiled every 3 over a random 3 kb genome, one in
    ten with a substitution, so paths hold several runs."""
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    bases = np.stack([g[s:s + 100] for s in range(0, len(g) - 100, 3)])
    noisy = np.flatnonzero(rng.random(len(bases)) < 0.1)
    pos = rng.integers(0, 100, len(noisy))
    bases[noisy, pos] = (bases[noisy, pos] + 1) % 4
    n = len(bases)
    return ReadSet(bases, np.full(n, 100, np.int32), np.full((n, 100), 35, np.uint8))


def _graph_on(reads, dev):
    d, _ = tke.count_kmers_device(reads.bases, reads.lengths, reads.quals, 60,
                                  min_freq=2, device=dev)
    tgb.recompute_adjacencies(d)
    return d, tgb.build_unitigs(d)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [tpather.RUN_SLOTS, 1])
def test_path_reads_on_the_card_match_the_cpu_route(monkeypatch, slots):
    """path_reads on a card dictionary packs each chunk with K0, one
    launch a chunk, and gives the CPU route's paths; slots=1 sends every
    chunk with a read of 2+ runs to the dense fallback (lookup_core on
    the same packed rows)."""
    _card()
    reads = _pathing_case()
    d_cpu, edges = _graph_on(reads, "cpu")
    d, card_edges = _graph_on(reads, "cuda")
    for a, b in zip(card_edges, edges):
        np.testing.assert_array_equal(a, b)
    hbv, fx, rx = tgb.build_hbv_from_edges(*edges, 60)
    monkeypatch.setattr(tpather, "RUN_SLOTS", slots)
    dense = []
    decode_chunk = tpather._decode_chunk
    monkeypatch.setattr(tpather, "_decode_chunk",
                        lambda *a: dense.append(1) or decode_chunk(*a))
    want = tpather.path_reads(reads, d_cpu, hbv, fx, rx, chunk_reads=256)
    before = tdev.LAUNCHES["pack"]
    got = tpather.path_reads(reads, d, hbv, fx, rx, chunk_reads=256)
    assert tdev.LAUNCHES["pack"] == before + -(-reads.n_reads // 256)
    assert (len(dense) > 0) == (slots == 1)
    for key in ("offsets", "edges", "start"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert len(got.edges) > 0
