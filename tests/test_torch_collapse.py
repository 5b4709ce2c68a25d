"""K2 collapse: the port's plain version against the JAX package's Pallas
kernel in interpret mode (+ gather_unique), a numpy model of the CUDA
kernel (csrc/collapse.cu) against the plain version, and, on a card, the
CUDA kernel against the plain version.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from w2rap_contigger_tpu.ops import pallas_collapse as pcol
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import collapse as kcol
from w2rap_contigger_tpu_torch.ops.kmer_engine import compact_tiles
from _torch_guards import time_limited  # noqa: F401

FULL = np.uint32(0xFFFFFFFF)
TILE = 256  # port tile == JAX tile_rows=2 x 128 lanes


def _stream(rng, W, n):
    """Sorted (W+1, n) u32 stream: short segments crossing tile edges,
    one run longer than a tile with counts summing past 255, then
    sentinels (at least one, as the TPU kernel needs)."""
    short = rng.integers(1, 40, size=n)
    head = short[: np.searchsorted(np.cumsum(short), TILE + 50)]
    tail = short[len(head) :]
    lens = np.concatenate([head, [3 * TILE + 17], tail])
    lens = lens[np.cumsum(lens) <= int(n * 0.9)]
    m = len(lens)
    lead = np.cumsum(rng.integers(1, 1 << 16, size=m)).astype(np.uint64)
    uniq = rng.integers(0, 1 << 32, size=(m, W), dtype=np.uint64).astype(np.uint32)
    uniq[:, 0] = (lead >> np.uint64(32)).astype(np.uint32)
    uniq[:, 1] = (lead & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words = np.repeat(uniq, lens, axis=0)
    n_real = words.shape[0]
    cnt = rng.integers(1, 4, size=n_real).astype(np.uint32)
    ctx = rng.integers(0, 256, size=n_real).astype(np.uint32)
    planes = np.full((W + 1, n), FULL, dtype=np.uint32)
    planes[:W, :n_real] = words.T
    planes[W] = 0
    planes[W, :n_real] = (ctx << 8) | cnt
    return planes


@pytest.mark.parametrize("W,min_count", [(4, 1), (4, 4), (13, 1), (13, 4)])
def test_collapse_plain_matches_pallas(rng, W, min_count):
    planes = _stream(rng, W, 8 * TILE)
    jout, jcounts, jlow = pcol.collapse_compact(
        [jnp.asarray(p) for p in planes], tile_rows=TILE // 128,
        interpret=True, min_count=min_count,
    )
    jw, jctx, jcnt = pcol.gather_unique(jout, jcounts)
    assert int(jcnt.max()) == 255  # the long run saturates

    out, tile_counts, low = kcol.collapse(
        torch.from_numpy(planes.view(np.int32)), min_count=min_count, tile=TILE
    )
    assert out.shape == planes.shape and tile_counts.shape == (8,)
    table = compact_tiles(out, tile_counts, TILE, int(tile_counts.sum())).numpy().view(np.uint32)
    np.testing.assert_array_equal(table[:W].T, jw)
    np.testing.assert_array_equal((table[W] >> 8) & 0xFF, jctx)
    np.testing.assert_array_equal(table[W] & 0xFF, jcnt)
    # only bins 1..min_count-1 are defined (the TPU stats block repeats
    # the kept count in its other lanes); the port's other bins are 0
    np.testing.assert_array_equal(
        low.numpy()[1:min_count], np.asarray(jlow)[1:min_count]
    )
    assert low.numpy()[min_count:].sum() == 0 and low.numpy()[0] == 0
    assert int(tile_counts.sum()) == int(np.asarray(jcounts).sum())
    if min_count > 1:
        assert low.numpy()[1:min_count].sum() > 0
    # rows after each tile's kept prefix are sentinels with payload 0
    o = out.numpy().view(np.uint32)
    for t, c in enumerate(tile_counts.tolist()):
        assert (o[:, t * TILE + c : (t + 1) * TILE][:W] == FULL).all()
        assert (o[W, t * TILE + c : (t + 1) * TILE] == 0).all()


@pytest.mark.parametrize("W", [4, 13])
def test_collapse_midstream_sentinels_match_pallas(rng, W):
    """The partition sort's layout: sorted regions, each followed by a run
    of sentinel rows (short, long, and longer than a tile), padded to the
    8 tiles and min_count 4 of test_collapse_plain_matches_pallas, whose
    interpret-mode program it shares."""
    base = _stream(rng, W, 6 * TILE)
    real = base[:, ~(base[:W] == FULL).all(axis=0)]
    edges = np.flatnonzero((real[:W, 1:] != real[:W, :-1]).any(axis=0)) + 1
    cuts = np.sort(rng.choice(edges, size=3, replace=False))
    sent = lambda m: np.concatenate(  # noqa: E731
        [np.full((W, m), FULL, np.uint32), np.zeros((1, m), np.uint32)])
    parts = []
    for piece, gap in zip(np.split(real, cuts, axis=1), (1, 100, TILE + 5, 7)):
        parts += [piece, sent(gap)]
    planes = np.concatenate(parts, axis=1)
    planes = np.concatenate([planes, sent(8 * TILE - planes.shape[1])], axis=1)
    jout, jcounts, jlow = pcol.collapse_compact(
        [jnp.asarray(p) for p in planes], tile_rows=TILE // 128,
        interpret=True, min_count=4,
    )
    jw, jctx, jcnt = pcol.gather_unique(jout, jcounts)
    out, tile_counts, low = kcol.collapse(
        torch.from_numpy(planes.view(np.int32)), min_count=4, tile=TILE
    )
    table = compact_tiles(out, tile_counts, TILE, int(tile_counts.sum())).numpy().view(np.uint32)
    assert table.shape[1] == len(jw) > 0
    np.testing.assert_array_equal(table[:W].T, jw)
    np.testing.assert_array_equal((table[W] >> 8) & 0xFF, jctx)
    np.testing.assert_array_equal(table[W] & 0xFF, jcnt)
    np.testing.assert_array_equal(low.numpy()[1:4], np.asarray(jlow)[1:4])


def test_collapse_checks_inputs():
    p = torch.zeros((5, 512), dtype=torch.int32)
    with pytest.raises(ValueError):
        kcol.collapse(p.to(torch.int64))
    with pytest.raises(ValueError):
        kcol.collapse(p, min_count=200)
    with pytest.raises(ValueError):
        kcol.collapse(p, tile=100)


@pytest.mark.cuda
def test_collapse_kernel_matches_plain(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for W, mc in ((4, 4), (13, 1)):
        planes = torch.from_numpy(_stream(rng, W, 64 * TILE).view(np.int32)).cuda()
        before = tdev.LAUNCHES["collapse"]
        got = kcol.collapse(planes, min_count=mc, tile=TILE)
        assert tdev.LAUNCHES["collapse"] == before + 1
        want = kcol.collapse_plain(planes, min_count=mc, tile=TILE)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # the model's edge cases: tile edges, walks, saturation, sentinels;
    # n % 4 != 0 takes the kernel's scalar loads
    for W, tile, mc in MODEL_CASES:
        for n in (20 * tile + tile // 2 + 4, 20 * tile + tile // 2 + 3):
            planes = _model_stream(rng, W, n, tile, n_real=20 * tile)
            planes = torch.from_numpy(planes.view(np.int32)).cuda()
            got = kcol.collapse(planes, min_count=mc, tile=tile)
            want = kcol.collapse_plain(planes, min_count=mc, tile=tile)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def _comb(a, b):
    """collapse.cu's comb: ctx OR-ed, cnt added saturating at 255."""
    return ((a | b) & 0xFF00) | np.minimum((a & 0xFF) + (b & 0xFF), 255)


def _seg_comb(f, v, pf, pv):
    """(pf, pv) precedes (f, v)."""
    return f | pf, np.where(f, v, _comb(pv, v))


def _collapse_model(planes, min_count, tile):
    """K2 as csrc/collapse.cu computes it, in numpy, every tile and thread
    at once: V-row chunks a thread, the start and all-ones masks plane by
    plane (a thread's previous row by a shuffle, a warp's first lane by a
    load), the end mask, the segmented scan (sequential in a thread, by
    shuffles in a warp, over the warps in the block), the block-wide
    walk back for a tile's first segment with its stop at the segment's
    start or at saturation, and the ordered compaction with fill."""
    V, T = kcol.ROWS_PER_THREAD, kcol.KERNEL_THREADS
    MAX_TILE = kcol.MAX_KERNEL_TILE
    assert tile % 256 == 0 and tile <= MAX_TILE
    W, n = planes.shape[0] - 1, planes.shape[1]
    words = planes[:W]
    pay_in = planes[W].astype(np.int64) & 0xFFFF
    n_tiles = -(-n // tile)
    tile0 = np.arange(n_tiles)[:, None, None] * tile
    tile_end = np.minimum(tile0 + tile, n)
    row0 = tile0 + np.arange(T)[None, :, None] * V
    row = row0 + np.arange(V)[None, None, :]
    valid = row < tile_end
    rc = np.where(valid, row, 0)
    lane = np.arange(T)[None, :] % 32
    tail = (tile_end[:, 0, 0] < n)  # the last thread compares the next tile's first row
    diff = np.zeros(row.shape, dtype=bool)
    ones = valid.copy()
    next_diff = np.zeros(n_tiles, dtype=bool)
    last_t = (tile_end[:, 0, 0] - tile0[:, 0, 0] - 1) // V  # the thread of the tile's last row
    for j in range(W):
        w = words[j][rc]
        prev = np.empty_like(w)
        prev[:, :, 1:] = w[:, :, :-1]
        shfl = np.concatenate([w[:, :1, V - 1], w[:, :-1, V - 1]], axis=1)  # lane 0 keeps its own
        load = words[j][np.clip(row0[:, :, 0] - 1, 0, n - 1)]
        prev[:, :, 0] = np.where((lane == 0) & (row0[:, :, 0] > 0) & valid[:, :, 0], load, shfl)
        diff |= w != prev
        ones &= w == FULL
        tl = np.arange(n_tiles)[tail]
        next_diff[tl] |= words[j][tile_end[tail, 0, 0]] != w[tl, last_t[tail], V - 1]
    diff[row == 0] = True
    start = diff & valid
    nv = valid.sum(axis=2)
    head = np.zeros((n_tiles, T + 1), dtype=bool)
    head[:, :T] = start[:, :, 0]
    end = np.zeros_like(start)
    end[:, :, :-1] = start[:, :, 1:]
    has = nv > 0
    lastrow = row0[:, :, 0] + nv - 1
    last = np.where(lastrow == n - 1, True,
                    np.where(has & (lastrow == tile_end[:, :, 0] - 1) & tail[:, None],
                             next_diff[:, None], head[:, 1:]))
    ti, th = np.nonzero(has)
    end[ti, th, nv[ti, th] - 1] |= last[ti, th]
    end &= valid

    pay = np.where(valid, pay_in[rc], 0)
    f = np.zeros((n_tiles, T), dtype=bool)
    val = np.zeros((n_tiles, T), dtype=np.int64)
    for v in range(V):
        s, ok = start[:, :, v], valid[:, :, v]
        val = np.where(ok, np.where(s, pay[:, :, v], _comb(val, pay[:, :, v])), val)
        f |= ok & s
    fw, vw = f.reshape(n_tiles, -1, 32), val.reshape(n_tiles, -1, 32)
    for off in (1, 2, 4, 8, 16):
        pf = np.zeros_like(fw)
        pv = np.zeros_like(vw)
        pf[:, :, off:], pv[:, :, off:] = fw[:, :, :-off], vw[:, :, :-off]
        nf, nv_ = _seg_comb(fw, vw, pf, pv)
        fw = np.where(np.arange(32) >= off, nf, fw)
        vw = np.where(np.arange(32) >= off, nv_, vw)
    cf = np.zeros_like(fw)
    cv = np.zeros_like(vw)
    cf[:, :, 1:], cv[:, :, 1:] = fw[:, :, :-1], vw[:, :, :-1]
    bf = np.zeros((n_tiles, 1), dtype=bool)
    bv = np.zeros((n_tiles, 1), dtype=np.int64)
    for q in range(T // 32):  # each warp's carry: the warps before it
        cf[:, q], cv[:, q] = _seg_comb(cf[:, q], cv[:, q], bf, bv)
        bf, bv = _seg_comb(fw[:, q, 31:], vw[:, q, 31:], bf, bv)
    f, val = cf.reshape(n_tiles, T), cv.reshape(n_tiles, T)
    first = np.full(n_tiles, -1)
    first_val = np.zeros(n_tiles, dtype=np.int64)
    for v in range(V):
        s, ok = start[:, :, v], valid[:, :, v]
        val = np.where(ok, np.where(s, pay[:, :, v], _comb(val, pay[:, :, v])), val)
        f |= ok & s
        pay[:, :, v] = np.where(ok, val, pay[:, :, v])
        hit = ok & ~f & end[:, :, v] & ~ones[:, :, v]
        ti, th = np.nonzero(hit)
        assert len(np.unique(ti)) == len(ti)  # one first segment a tile
        first[ti] = th * V + v
        first_val[ti] = val[ti, th]

    walks = {}
    for t in np.flatnonzero(first >= 0):
        t0 = t * tile
        key = words[:, t0]
        walk, hi_ = 0, t0
        while True:
            lo_ = max(hi_ - MAX_TILE, 0)
            rows = hi_ - 1 - np.arange(hi_ - lo_)  # k = tid * V + v
            eq = (words[:, rows] == key[:, None]).all(axis=0)
            stop = int(np.argmin(eq)) if not eq.all() else MAX_TILE
            part = pay_in[rows[:stop]]
            walk = _comb(walk, (np.bitwise_or.reduce(part) & 0xFF00 if len(part) else 0)
                         | min(int((part & 0xFF).sum()), 255))
            if stop < MAX_TILE or lo_ == 0 or _comb(walk, first_val[t]) == 0xFFFF:
                break
            hi_ = lo_
        walks[t] = walk
        th, v = divmod(first[t], V)
        pay[t, th, v] = _comb(walk, pay[t, th, v])

    live = end & ~ones
    cnt = pay & 0xFF
    keep = live & ((min_count <= 1) | (cnt >= min_count))
    low = np.zeros(kcol.LOW_BINS, dtype=np.int64)
    drop = live & ~keep & (cnt >= 1)
    np.add.at(low, cnt[drop], 1)

    out = np.full(planes.shape, FULL, dtype=np.uint32)
    out[W] = 0
    counts = keep.reshape(n_tiles, -1).sum(axis=1)
    for t in range(n_tiles):
        k = keep[t].reshape(-1)
        src = row[t].reshape(-1)[k]
        dst = t * tile + np.arange(len(src))
        out[:W, dst] = words[:, src]
        out[W, dst] = pay[t].reshape(-1)[k]
    return out, counts.astype(np.int32), low.astype(np.int32), walks


def _model_stream(rng, W, n, tile, n_real=None):
    """(W+1, n) u32 sorted by segments, laid out around the tiles: short
    segments (1..40 rows); one ending on a tile's last row (the next
    starting on a tile's first row); one crossing one tile edge and one
    crossing two; one of 5 tiles and 7 rows whose ctx is one value but
    for its first row (it never saturates, and a walk that stops short
    misses bit 0); a run of sentinel rows longer than a tile mid-stream;
    then sentinels.  cnt 1..3 a row, so long segments saturate cnt."""
    lens, kinds = [], []
    pos = 0

    def add(m, kind="short"):
        nonlocal pos
        lens.append(m)
        kinds.append(kind)
        pos += m

    def shorts(upto):
        while pos < upto:
            add(int(min(rng.integers(1, 41), max(upto - pos, 1))))

    shorts(tile + 10)
    add(-pos % tile or tile, "to_edge")
    shorts(pos + 50)
    add(tile // 2 + 33, "cross1")
    shorts(pos + 40)
    add(2 * tile - 20, "cross2")
    add(5 * tile + 7, "one_ctx")
    shorts(pos + 30)
    add(tile + 5, "sentinel")
    shorts(pos + 100)
    add(3 * tile + 1, "long")
    shorts(n_real or int(n * 0.9))
    lens = np.array(lens)
    m = len(lens)
    lead = np.cumsum(rng.integers(1, 1 << 16, size=m)).astype(np.uint64)
    uniq = rng.integers(0, 1 << 32, size=(m, W), dtype=np.uint64).astype(np.uint32)
    uniq[:, 0] = (lead >> np.uint64(32)).astype(np.uint32)
    uniq[:, 1] = (lead & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    kinds = np.array(kinds)
    uniq[kinds == "sentinel"] = FULL
    words = np.repeat(uniq, lens, axis=0)
    nr = words.shape[0]
    assert nr <= n
    cnt = rng.integers(1, 4, size=nr).astype(np.uint32)
    ctx = rng.integers(0, 256, size=nr).astype(np.uint32)
    kind_row = np.repeat(kinds, lens)
    one = np.flatnonzero(kind_row == "one_ctx")
    ctx[one] = 0x24
    ctx[one[0]] = 0x25  # only a walk that reaches the start sees bit 0
    sent = kind_row == "sentinel"
    planes = np.full((W + 1, n), FULL, dtype=np.uint32)
    planes[:W, :nr] = words.T
    planes[W] = 0
    planes[W, :nr] = np.where(sent, 0, (ctx << 8) | cnt | (rng.integers(0, 4, size=nr) << 16))
    return planes


# (W, tile, min_count): the kernel's tile 4096 and the JAX tests' 256
MODEL_CASES = [(4, 256, 1), (4, 256, 4), (13, 1024, 4), (17, 4096, 1), (5, 4096, 4)]


@pytest.mark.parametrize("W,tile,min_count", MODEL_CASES)
def test_collapse_model_matches_plain(rng, W, tile, min_count):
    n = 20 * tile + tile // 2 + 4  # a ragged last tile
    planes = _model_stream(rng, W, n, tile)
    out, counts, low, walks = _collapse_model(planes, min_count, tile)
    want = kcol.collapse_plain(torch.from_numpy(planes.view(np.int32)), min_count, tile)
    np.testing.assert_array_equal(out, want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(counts, want[1].numpy())
    np.testing.assert_array_equal(low, want[2].numpy())
    # the walks: the one-ctx segment (5 tiles) walks to its start unsaturated
    assert walks and max(w & 0xFF00 for w in walks.values()) == 0xFF00
    assert any((w & 0xFF00) == 0x2500 and (w & 0xFF) == 255 for w in walks.values())
    if min_count > 1:
        assert low[1:min_count].sum() > 0
