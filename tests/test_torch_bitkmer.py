"""The port's torch word-lane and KMerContext operations against the JAX
package's numpy forms (exact equality: all values are bit patterns)."""

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.ops import bitkmer as hbk
from w2rap_contigger_tpu.ops import context as hctx
from w2rap_contigger_tpu_torch.ops import bitkmer as bk
from w2rap_contigger_tpu_torch.ops import context as kctx
from _torch_guards import time_limited  # noqa: F401


def _kmers(rng, n, k):
    codes = rng.integers(0, 4, size=(n, k)).astype(np.uint8)
    # include palindromes: first half + rc of first half
    half = codes[: n // 8, : k // 2]
    codes[: n // 8, k - k // 2 :] = (3 - half)[:, ::-1][:, : k - k // 2]
    return hbk.pack_codes(codes, k)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("k", [25, 60, 200])
def test_word_ops_match_numpy(rng, k):
    w = _kmers(rng, 512, k)
    tw = _t(w)
    _eq(bk.revpair32(tw), hbk.revpair32(w))
    _eq(bk.rc_words(tw, k), hbk.rc_words(w, k))
    other = _kmers(rng, 512, k)
    other[::3] = w[::3]
    _eq(bk.words_lt(tw, _t(other)), hbk.words_lt(w, other))
    _eq(bk.words_eq(tw, _t(other)), hbk.words_eq(w, other))
    canon, is_rev = bk.canonicalize(tw, k)
    hcanon, his_rev = hbk.canonicalize(w, k)
    _eq(canon, hcanon)
    _eq(is_rev, his_rev)
    pal = bk.is_palindrome(tw, k)
    _eq(pal, hbk.is_palindrome(w, k))
    if k % 2 == 0:
        assert bool(pal.any())
    codes = rng.integers(0, 4, size=512)
    _eq(bk.to_successor(tw, _t(codes), k), hbk.to_successor(w, codes.astype(np.uint32), k))
    _eq(bk.to_predecessor(tw, _t(codes), k), hbk.to_predecessor(w, codes.astype(np.uint32), k))
    for c in range(4):
        _eq(bk.to_successor(tw, c, k), hbk.to_successor(w, np.uint32(c), k))
        _eq(bk.to_predecessor(tw, c, k), hbk.to_predecessor(w, np.uint32(c), k))
    _eq(bk.last_base(tw, k), hbk.last_base(w, k))
    for rows in (tw, tw[:0]):  # no rows, as a graph of smooth cycles alone gives
        np.testing.assert_array_equal(bk.unpack_words(rows, k).numpy(),
                                      hbk.unpack_words(rows.numpy(), k))


@pytest.mark.parametrize("k", [25, 60, 200])
def test_kmer_windows_match_packed_codes(rng, k):
    L = 250
    bases = rng.integers(0, 4, size=(16, L)).astype(np.uint8)
    packed = _t(hbk.pack_codes(bases, L))
    P = L - k + 1
    got = bk.kmer_windows(packed, k, P)
    want = np.stack(
        [hbk.pack_codes(bases[:, p : p + k], k) for p in range(P)], axis=1
    )
    _eq(got, want)


def test_raw32_round_trip_and_pair_key_order(rng):
    u = rng.integers(0, 1 << 32, size=(4096, 2), dtype=np.uint64).astype(np.uint32)
    u[:4] = [[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0x80000000, 0], [0x7FFFFFFF, 5]]
    raw = torch.from_numpy(u.view(np.int32))
    t = bk.from_raw32(raw)
    _eq(t, u)
    assert torch.equal(bk.to_raw32(t), raw)
    key = bk.pair_key(t[:, 0], t[:, 1])
    order = torch.argsort(key, stable=True).numpy()
    want = np.lexsort((u[:, 1], u[:, 0]))
    np.testing.assert_array_equal(u[order], u[want])


def test_context_ops_match_numpy():
    ctx = np.arange(256, dtype=np.uint32)
    tc = _t(ctx)
    _eq(kctx.rc_context(tc), hctx.rc_context(ctx))
    _eq(kctx.pred_bits(tc), hctx.pred_bits(ctx))
    _eq(kctx.succ_bits(tc), hctx.succ_bits(ctx))
    nib = np.arange(16, dtype=np.uint32)
    _eq(kctx.popcount4(_t(nib)), hctx.popcount4(nib))
    _eq(kctx.single_base(_t(nib)), hctx.single_base(nib))
    g = np.array(np.meshgrid(np.arange(4), np.arange(4), [0, 1], [0, 1])).reshape(4, -1)
    g = g.astype(np.uint32)
    _eq(
        kctx.make_context(*[_t(x) for x in g]),
        hctx.make_context(g[0], g[1], g[2], g[3]),
    )
