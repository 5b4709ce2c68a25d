"""K4 partition sort: the port's plain version against the JAX package's
Pallas kernels in interpret mode, at the JAX tests' tile_rows and n_bins
(tests/test_pallas_radix.py): splitters, overflow flag, each region's
count of valid rows and each region's rows (lexsorted by all planes, as
only the order of rows tied on the comparator words may differ); the
collision flag; the plain phases composed one by one; numpy models of
K4a's key-index network (csrc/radix.cu on csrc/keyindex_net.cuh) against
the plain tile sort, of K4b's slots (a block a tile and bin, warp
searches) against the plain partition, of K4c's merge path (csrc/region_merge.cu)
against the plain chunk sort and of K4d's merge path by the block
(csrc/radix.cu) against the plain merge level; and, on a card, every
kernel against its plain version.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from w2rap_contigger_tpu.ops import pallas_radix as prad
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import bitonic, radix
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from test_torch_bitonic import _key_index_net, _levels

FULL = np.uint32(0xFFFFFFFF)


def _stream(rng, n, w, n_unique=700, sentinel_frac=0.1):
    """(w+1, n) u32 planes: duplicated keys, some sharing their first 64
    bits, sentinel rows, payload a function of the key."""
    uniq = rng.integers(0, 1 << 32, size=(n_unique, w), dtype=np.uint64).astype(np.uint32)
    uniq[:, 0] &= np.uint32(0xFFFFFFF0)
    uniq[: n_unique // 4, :2] = uniq[n_unique // 4 : n_unique // 2, :2]
    rows = uniq[rng.integers(0, n_unique, size=n)]
    sent = rng.random(n) < sentinel_frac
    rows[sent] = FULL
    payload = np.where(sent, 0, rows[:, -1] ^ np.uint32(0xABCD1234)).astype(np.uint32)
    return np.concatenate([rows.T, payload[None]])


def _skewed(rng, n, w):
    """Zipf-ish multiplicities that still fit the slots (JAX's test)."""
    uniq = rng.integers(0, 1 << 31, size=(50, w), dtype=np.uint64).astype(np.uint32)
    uniq[:, 1] = np.arange(50, dtype=np.uint32)
    p = 1.0 / np.arange(1, 51)
    rows = uniq[np.sort(rng.choice(50, size=n, p=p / p.sum()))]
    rng.shuffle(rows)
    return np.concatenate([rows.T, (rows[:, 1] ^ np.uint32(0x55AA55AA))[None]])


def _overflowing(rng, n, w):
    """Every row the same key: one slot per tile must overflow."""
    return np.concatenate([np.full((w, n), 7, np.uint32), np.ones((1, n), np.uint32)])


def _ambiguous(rng, n, w):
    """Real rows whose first 64 bits are all ones (K >= 64)."""
    planes = _stream(rng, n, w)
    planes[:2, [5, 1234]] = FULL
    planes[2, [5, 1234]] = 3
    return planes


def _jax_splitters(planes, cmp_keys, tile_rows, n_bins):
    """JAX's splitter rule (pallas_radix.py:362-372) on lax-sorted tiles."""
    T = tile_rows * 128
    n_tiles = planes.shape[1] // T
    tiles = jax.lax.sort([jnp.asarray(p.reshape(n_tiles, T)) for p in planes[:cmp_keys]],
                         dimension=1, num_keys=cmp_keys)
    pos = (np.arange(n_tiles)[:, None] * T
           + (np.arange(1, n_bins) * (T // n_bins))[None, :] - 1).reshape(-1)
    samples = [np.asarray(t).reshape(-1)[pos] for t in tiles]
    ss = jax.lax.sort([jnp.asarray(s) for s in samples], num_keys=cmp_keys)
    sel = np.arange(1, n_bins) * n_tiles - 1
    return np.stack([np.asarray(s)[sel] for s in ss], axis=1)


def _regions(out, w, n_regions):
    """Per region: (valid count, valid rows lexsorted over all planes);
    valid rows must come first."""
    res = []
    for r in np.split(out, n_regions, axis=1):
        valid = ~(r[:w] == FULL).all(axis=0)
        nv = int(valid.sum())
        assert valid[:nv].all()
        rows = r[:, :nv]
        res.append((nv, rows[:, np.lexsort(rows[::-1])]))
    return res


CASES = {
    "w4": (_stream, 64 * 128, 4, 2, 16, 8),
    "w13_cmp4": (_stream, 64 * 128, 13, 4, 16, 8),
    "skewed": (_skewed, 64 * 128, 3, 2, 16, 4),
    "overflow": (_overflowing, 32 * 128, 2, 2, 8, 8),
    "ambiguous_w13": (_ambiguous, 32 * 128, 13, 2, 8, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_partition_sort_matches_jax(rng, case):
    make, n, w, cmp_keys, tile_rows, n_bins = CASES[case]
    planes = make(rng, n, w)
    jout, jover = prad.partition_sort([jnp.asarray(p) for p in planes], num_keys=w,
                                      cmp_keys=cmp_keys, tile_rows=tile_rows,
                                      n_bins=n_bins, interpret=True)
    jout = np.stack([np.asarray(p) for p in jout])
    out, over = radix.partition_sort(torch.from_numpy(planes.view(np.int32)), num_keys=w,
                                     cmp_keys=cmp_keys, tile_rows=tile_rows, n_bins=n_bins)
    out = out.numpy().view(np.uint32)
    assert out.shape == jout.shape
    assert int(over[0]) == int(jover)
    if case in ("overflow", "ambiguous_w13"):
        assert int(over[0]) > 0
        return
    assert int(over[0]) == 0

    T, n_tiles, nb, cap, region = radix.geometry(n, tile_rows, n_bins)
    recs = radix.tile_sort_plain(torch.from_numpy(planes.view(np.int32)), cmp_keys, T)
    sp_hi, sp_lo = radix.splitters(recs[0], recs[1], T, nb)
    got = np.stack([sp_hi.numpy().view(np.uint64) >> np.uint64(32),
                    sp_hi.numpy().view(np.uint64) & np.uint64(FULL),
                    sp_lo.numpy().view(np.uint64) >> np.uint64(32),
                    sp_lo.numpy().view(np.uint64) & np.uint64(FULL)], axis=1)
    np.testing.assert_array_equal(got[:, :cmp_keys], _jax_splitters(planes, cmp_keys, tile_rows, nb))
    for (na, ra), (nb_, rb) in zip(_regions(out, w, nb), _regions(jout, w, nb)):
        assert na == nb_
        np.testing.assert_array_equal(ra, rb)
    # ascending on the comparator words inside every region
    for r in np.split(out, nb, axis=1):
        key = r[:cmp_keys].astype(np.uint64)
        order = np.lexsort(key[::-1])
        np.testing.assert_array_equal(order, np.arange(r.shape[1]))


def test_collision_flag_matches_jax(rng):
    a = np.array([[1, 2, 3, 4], [1, 2, 9, 4], [5, 6, 7, 8], [5, 6, 7, 8]], dtype=np.uint32)
    rand = _stream(rng, 4096, 4)[:4].T
    for rows, cmp_keys in ((a, 2), (a, 3), (rand, 2), (rand, 1)):
        planes = np.ascontiguousarray(rows.T)
        want = int(prad.collision_flag([jnp.asarray(p) for p in planes], num_keys=4,
                                       cmp_keys=cmp_keys))
        got = int(radix.collision_flag(torch.from_numpy(planes.view(np.int32)), 4, cmp_keys))
        assert got == want
    assert got > 0


def test_phases_compose_to_the_plain_sort(rng):
    """tile_sort -> splitters -> partition -> region_sort -> merge passes
    -> gather (the kernels' phases, in plain torch) equals the plain
    sort, on a tile count that is not a power of two."""
    w, n = 5, 3 * 2048
    planes = torch.from_numpy(_stream(rng, n, w).view(np.int32))
    T, n_tiles, nb, cap, region = radix.geometry(n, 16, 4)
    s = radix.tile_sort_plain(planes, 4, T)
    sp = radix.splitters(s[0], s[1], T, nb)
    *recs, over = radix.partition_plain(planes, *s, *sp, w, 4, T, nb, cap)
    C = min(T, region)
    widths = radix.merge_widths(region, C)
    assert widths  # at least one merge level
    recs = radix.region_sort_plain(*recs, region, C)
    for wd in widths:
        recs = radix.merge_pass_plain(*recs, region, wd)
    out = radix.gather_plain(recs[2], planes, w)
    want, want_over = radix.partition_sort_plain(planes, w, 4, 16, 4)
    assert torch.equal(out, want) and torch.equal(over, want_over)


def _k4a_model(planes, cmp_keys, T):
    """K4a as csrc/radix.cu computes it, in numpy: the key-index network
    on every tile's first cmp_keys words, the direction taken from the
    tile row (so every tile ends ascending), ties on the first word
    broken by the later words and then by the tile row (two rows all
    ones in the compared words at once), and each record written through
    the final rows: hi = w0 << 32 | w1, lo = w2 << 32 | w3 (missing words
    0), idx = the input row."""
    n = planes.shape[1]
    R = bitonic.tile_geometry(T, cmp_keys)["R"]
    words = np.zeros((4, n), dtype=np.uint64)
    words[:cmp_keys] = planes[:cmp_keys]
    rows = np.empty(n, dtype=np.int64)
    levels = [(lv, lv // 2) for lv in _levels(2, T)]
    for base in range(0, n, T):
        ix, _ = _key_index_net(planes[:cmp_keys, base:base + T], cmp_keys, R,
                               np.arange(T // R) * R, levels, by_row=True)
        rows[base:base + T] = base + ix.reshape(-1)
    hi = (words[0][rows] << np.uint64(32)) | words[1][rows]
    lo = (words[2][rows] << np.uint64(32)) | words[3][rows]
    return hi, lo, rows.astype(np.uint32)


def _tie_rows(rng, n, w, cmp_keys, tie_first):
    """(w+1, n) u32: key words from 8 values (half >= 2^31), 10% sentinel
    rows, 5% of rows all ones in their first cmp_keys words only (real
    rows that tie with sentinels there), 90% of rows sharing their first
    word when tie_first; payload the row index."""
    vals = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, FULL],
                    dtype=np.uint32)
    keys = vals[rng.integers(0, len(vals), size=(w, n))]
    if tie_first:
        keys[0, rng.random(n) < 0.9] = 0x80000000
    keys[:cmp_keys, rng.random(n) < 0.05] = FULL
    keys[:, rng.random(n) < 0.1] = FULL
    return np.concatenate([keys, np.arange(n, dtype=np.uint32)[None]])


# (cmp_keys, tile T, tiles): R = 2 at T = 128 and 2048, 8 at 8192; odd
# tile counts, whose odd tiles a global-row direction would sort
# descending
K4A_CASES = [(1, 128, 5), (2, 2048, 3), (3, 128, 3), (4, 8192, 3), (4, 2048, 5)]


@pytest.mark.parametrize("cmp_keys,T,tiles", K4A_CASES)
def test_k4a_model_matches_plain(rng, cmp_keys, T, tiles):
    """On tie-heavy rows of 5 key words and on rows 90% tied on their
    first word, with rows all ones in the comparator words."""
    for tie_first in (False, True):
        planes = _tie_rows(rng, T * tiles, 5, cmp_keys, tie_first)
        want = radix.tile_sort_plain(torch.from_numpy(planes.view(np.int32)), cmp_keys, T)
        got = _k4a_model(planes, cmp_keys, T)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy().view(g.dtype))
        # the rows all ones in the comparator words end each tile, in row order
        full = (planes[:cmp_keys] == FULL).all(axis=0)
        for base in range(0, T * tiles, T):
            nf = int(full[base:base + T].sum())
            tail = got[2][base + T - nf:base + T]
            assert full[tail].all() and (np.diff(tail.astype(np.int64)) > 0).all()


MAX64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sw(k):
    """region_merge.cu's shared-memory swizzle (radix.cu's K4d output
    staging too)."""
    return k ^ ((k >> 4) & 15)


def _rec_less(ah, al, ai, bh, bl, bi):
    return (ah < bh) | ((ah == bh) & ((al < bl) | ((al == bl) & (ai < bi))))


def _merge_model(recs, region, C, run):
    """K4c as region_merge.cu computes it, in numpy, one chunk at a time
    and every thread of the block at once: the chunk padded with fill to
    m in swizzled shared memory, each run's real count where its fill
    tail starts, then per level each thread's co-rank by binary search
    (a <= b takes the left run first), its P outputs merged from the two
    heads, and the write-back."""
    g = radix.region_merge_geometry(C, run)
    m, threads, P = g["m"], g["threads"], g["P"]
    assert threads * P == m and g["levels"] == (m // run).bit_length() - 1
    hi = recs[0].numpy().view(np.uint64)
    lo = recs[1].numpy().view(np.uint64)
    idx = recs[2].numpy().view(np.uint32)
    out = [hi.copy(), lo.copy(), idx.copy()]
    k0 = np.arange(threads) * P
    pos = np.arange(m)
    assert np.array_equal(np.sort(_sw(pos)), pos)  # a bijection of [0, m)
    for start in [r + c for r in range(0, len(hi), region) for c in range(0, region, C)]:
        ln = min(C, region - start % region)
        sh = np.full(m, MAX64)
        sl = np.full(m, MAX64)
        si = np.full(m, FULL)
        sh[_sw(pos[:ln])], sl[_sw(pos[:ln])], si[_sw(pos[:ln])] = (
            hi[start:start + ln], lo[start:start + ln], idx[start:start + ln])
        real = si[_sw(pos)] != FULL
        ends = real & (((pos + 1) % run == 0) | ~np.append(real[1:], False)) & (pos < ln)
        n_real = np.zeros(m // run, dtype=np.int64)
        assert np.bincount(pos[ends] // run, minlength=m // run).max(initial=0) <= 1
        n_real[pos[ends] // run] = pos[ends] % run + 1

        def at(k):
            q = _sw(k)
            return sh[q], sl[q], si[q]

        w = run
        while w < m:
            pair = k0 // (2 * w)
            d = k0 - pair * 2 * w
            a0, b0 = pair * 2 * w, pair * 2 * w + w
            na, nb = n_real[2 * pair], n_real[2 * pair + 1]
            lo_i = np.where(d > nb, d - nb, 0)
            hi_i = np.minimum(d, na)
            live = d < na + nb
            while True:
                go = live & (lo_i < hi_i)
                if not go.any():
                    break
                mid = (lo_i + hi_i) >> 1
                a = at(np.where(go, a0 + mid, 0))
                b = at(np.where(go, b0 + d - 1 - mid, 0))
                le = ~_rec_less(*b, *a)
                lo_i = np.where(go & le, mid + 1, lo_i)
                hi_i = np.where(go & ~le, mid, hi_i)
            i = np.where(live, lo_i, na)
            j = np.where(live, d - lo_i, nb)
            o = [np.empty((threads, P), dtype=x.dtype) for x in (sh, sl, si)]
            for u in range(P):
                ha = [np.where(i < na, x, f) for x, f in zip(at(a0 + np.minimum(i, w - 1)), (MAX64, MAX64, FULL))]
                hb = [np.where(j < nb, x, f) for x, f in zip(at(b0 + np.minimum(j, w - 1)), (MAX64, MAX64, FULL))]
                take_a = ~_rec_less(*hb, *ha)
                for x, ya, yb in zip(o, ha, hb):
                    x[:, u] = np.where(take_a, ya, yb)
                i = i + take_a
                j = j + ~take_a
            q = _sw(k0[:, None] + np.arange(P))
            sh[q], sl[q], si[q] = o
            n_real[pair[d == 0]] = (na + nb)[d == 0]
            w *= 2
        for x, y in zip(out, (sh, sl, si)):
            x[start:start + ln] = y[_sw(pos[:ln])]
    return [torch.from_numpy(out[0].view(np.int64)), torch.from_numpy(out[1].view(np.int64)),
            torch.from_numpy(out[2].view(np.int32))]


MAX64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _count_below_warp(hi, lo, kh, kl):
    """radix.cu count_below_warp on every (tile, key) at once: hi, lo
    (tiles, T) sorted u64 records, kh, kl (tiles,) keys; 32 probes a
    step, "below" holds on a prefix of the lanes, the ballot's count keeps
    one gap of the stride.  Returns #records < key of each tile, and the
    steps taken."""
    tiles, T = hi.shape
    lo_i = np.zeros(tiles, np.int64)
    hi_i = np.full(tiles, T, np.int64)
    lanes = np.arange(32)
    steps = 0
    while (lo_i < hi_i).any():
        act = lo_i < hi_i
        s = np.where(act, (hi_i - lo_i + 31) // 32, 1)
        p = lo_i[:, None] + lanes[None, :] * s[:, None]
        ok = act[:, None] & (p < hi_i[:, None])
        pc = np.where(ok, p, 0)
        ph = np.take_along_axis(hi, pc, 1)
        pl = np.take_along_axis(lo, pc, 1)
        below = ok & ((ph < kh[:, None]) | ((ph == kh[:, None]) & (pl < kl[:, None])))
        c = below.sum(axis=1)
        assert (below == (lanes[None, :] < c[:, None])).all()  # a prefix: the ballot's count
        nhi = lo_i + c * s
        lo_i = np.where(act & (c > 0), lo_i + (c - 1) * s + 1, lo_i)
        hi_i = np.where(act, np.minimum(nhi, hi_i), hi_i)
        steps += 1
    return lo_i, steps


def _k4b_model(planes, s_hi, s_lo, s_idx, sp_hi, sp_lo, num_keys, cmp_keys, T,
               n_bins, cap):
    """K4b as csrc/radix.cu computes it, in numpy: block (t, b) finds its
    bin's edges with two warp searches (the last bin's end at the
    all-ones key, then past the tail's ambiguous rows, counted from the
    planes), adds its overflow, and stores its slot PART_V = 4 records a
    thread (the bin's rows, then fill)."""
    P = planes.numpy().view(np.uint32)
    n = P.shape[1]
    n_tiles = n // T
    region = n_tiles * cap
    hi = s_hi.numpy().view(np.uint64).reshape(n_tiles, T)
    lo = s_lo.numpy().view(np.uint64).reshape(n_tiles, T)
    idx = s_idx.numpy().view(np.uint32).reshape(n_tiles, T)
    sph, spl = sp_hi.numpy().view(np.uint64), sp_lo.numpy().view(np.uint64)
    ones_h = MAX64 if cmp_keys >= 2 else MAX64 << np.uint64(32)
    ones_l = MAX64 if cmp_keys >= 4 else (MAX64 << np.uint64(32) if cmp_keys == 3
                                          else np.uint64(0))
    edges = np.zeros((n_tiles, n_bins + 1), np.int64)
    steps = 0
    for b in range(n_bins):  # edges[:, b + 1]: #records < splitter b (all ones: the last)
        kh = np.full(n_tiles, sph[b] if b < n_bins - 1 else ones_h, np.uint64)
        kl = np.full(n_tiles, spl[b] if b < n_bins - 1 else ones_l, np.uint64)
        edges[:, b + 1], st = _count_below_warp(hi, lo, kh, kl)
        steps = max(steps, st)
    assert steps <= int(np.ceil(np.log(T + 1) / np.log(33))) + 1
    n_full = T - edges[:, n_bins]
    ov = 0
    for t in range(n_tiles):  # the last bin's block: the tail's sentinel rows
        tail = idx[t, T - n_full[t]:]
        sent = (P[cmp_keys:num_keys][:, tail] == 0xFFFFFFFF).all(axis=0)
        n_sent = int(sent.sum())
        edges[t, n_bins] = T - n_sent
        ov += int(n_full[t]) - n_sent
    cnt = edges[:, 1:] - edges[:, :-1]
    ov += int((cnt > cap - 128).sum())
    take = np.clip(cnt, 0, cap)
    r = [np.full(n_bins * region, MAX64, np.uint64), np.full(n_bins * region, MAX64, np.uint64),
         np.full(n_bins * region, 0xFFFFFFFF, np.uint32)]
    for t in range(n_tiles):
        for b in range(n_bins):
            dst0 = b * region + t * cap
            assert dst0 % 4 == 0  # the slot's 16-byte vector stores
            for j in range(0, cap, 4):
                u = j + np.arange(4)
                inn = u < take[t, b]
                src = np.where(inn, edges[t, b] + u, 0)
                for x, y, f in zip(r, (hi[t], lo[t], idx[t]), (MAX64, MAX64, 0xFFFFFFFF)):
                    x[dst0 + u] = np.where(inn, y[src], f)
    return (torch.from_numpy(r[0].view(np.int64)), torch.from_numpy(r[1].view(np.int64)),
            torch.from_numpy(r[2].view(np.int32)), torch.tensor([ov], dtype=torch.int32))


def _own_layout(rng, n, w):
    """The port's radix stream (kmer_engine.Stream): no invalid row (the
    stream drops them), n - 10 real rows, the 10 padding rows spread at
    the ends of the 2048-row tiles."""
    real = torch.from_numpy(_stream(rng, n - 10, w, sentinel_frac=0.0).view(np.int32))
    return tke.spread_padding(real, w, 2048).numpy().view(np.uint32)


K4B_CASES = {
    # (make, n, w, cmp_keys, tile_rows, n_bins): 10% sentinel rows
    # (every tile's tail checked against 9 later key words), the port's
    # own layout, real rows all ones in their comparator words, one slot
    # a tile overflowing, and one bin
    "sentinel_tails": (_stream, 3 * 2048, 13, 4, 16, 4),
    "own_layout": (_own_layout, 3 * 2048, 13, 4, 16, 4),
    "ambiguous": (_ambiguous, 2 * 4096, 13, 2, 32, 8),
    "overflowing_slot": (_overflowing, 2 * 2048, 4, 4, 16, 4),
    "one_bin": (_stream, 5 * 128, 5, 3, 1, 1),
}


def _k4b_args(rng, case):
    make, n, w, cmp_keys, tile_rows, n_bins = K4B_CASES[case]
    planes = torch.from_numpy(np.ascontiguousarray(make(rng, n, w)).view(np.int32))
    T, n_tiles, nb, cap, region = radix.geometry(planes.shape[1], tile_rows, n_bins)
    s = radix.tile_sort_plain(planes, cmp_keys, T)
    sp = radix.splitters(s[0], s[1], T, nb)
    return (planes, *s, *sp, w, cmp_keys, T, nb, cap)


@pytest.mark.parametrize("case", list(K4B_CASES))
def test_k4b_model_matches_plain(rng, case):
    args = _k4b_args(rng, case)
    want = radix.partition_plain(*args)
    got = _k4b_model(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    overflow = int(want[3][0])
    assert (overflow > 0) == (case in ("ambiguous", "overflowing_slot"))
    if case == "own_layout":  # a few padding rows a tile, no sentinel mid-tile
        planes, T = args[0], args[8]
        pad = (planes[:13] == -1).all(dim=0).reshape(-1, T)
        assert 0 < int(pad.sum(dim=1).max()) < 8 and pad[:, : T // 2].sum() == 0


@pytest.mark.cuda
def test_k4b_kernel_matches_plain(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for case in K4B_CASES:
        args = [a.cuda() if torch.is_tensor(a) else a for a in _k4b_args(rng, case)]
        before = tdev.LAUNCHES["radix_partition"]
        got = radix.partition(*args)
        want = radix.partition_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert tdev.LAUNCHES["radix_partition"] == before + 1


def _slots(rng, n, w, tile_rows, n_bins, make=None):
    """K4b's slots of a stream (the plain phases K4a, splitters, K4b):
    records, region, the chunk C and the run length the sort uses."""
    planes = torch.from_numpy((make or _stream)(rng, n, w).view(np.int32))
    T, n_tiles, nb, cap, region = radix.geometry(n, tile_rows, n_bins)
    s = radix.tile_sort_plain(planes, 4, T)
    sp = radix.splitters(s[0], s[1], T, nb)
    *recs, over = radix.partition_plain(planes, *s, *sp, w, 4, T, nb, cap)
    C = min(T, region)
    return recs, region, C, min(cap, C)


MERGE_CASES = {
    # (n, w, tile_rows, n_bins): 8 runs a chunk; 3 runs padded to 4 (one
    # chunk a region, region < T); 2 runs and a short 1-run last chunk
    # (region 3 * cap > T); n_bins = 1 (one run: no level)
    "slots_8_runs": (8 * 8192, 5, 64, 16),
    "3_runs_padded_to_4": (3 * 8192, 5, 64, 8),
    "short_last_chunk": (3 * 4096, 3, 32, 4),
    "one_bin": (2 * 2048, 4, 16, 1),
}


@pytest.mark.parametrize("make", ["stream", "skewed"])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_region_merge_model_matches_plain(rng, case, make):
    """On duplicated keys with sentinels, and on Zipf-ish multiplicities
    (long runs of records tied on hi and lo, settled by idx)."""
    n, w, tile_rows, n_bins = MERGE_CASES[case]
    recs, region, C, run = _slots(rng, n, w, tile_rows, n_bins,
                                  {"stream": _stream, "skewed": _skewed}[make])
    levels = {"slots_8_runs": 3, "3_runs_padded_to_4": 2, "short_last_chunk": 1, "one_bin": 0}
    assert radix.region_merge_geometry(C, run)["levels"] == levels[case]
    want = radix.region_sort_plain(*recs, region, C)
    got = _merge_model(recs, region, C, run)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_region_merge_model_on_full_and_empty_runs(rng):
    """Runs with no fill at all and runs that are all fill, mixed in one
    chunk, through the model."""
    recs, region, C, run = _slots(rng, 8 * 8192, 5, 64, 16)
    hi, lo, idx = (r.clone() for r in recs)
    n_runs = hi.shape[0] // run
    for q in range(0, n_runs, 3):  # every third run full of real records
        a = q * run
        key = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=run))
        key = torch.sort(key).values
        hi[a:a + run] = key
        lo[a:a + run] = torch.arange(run)
        idx[a:a + run] = torch.arange(10_000_000 + a, 10_000_000 + a + run, dtype=torch.int32)
    for q in range(1, n_runs, 3):  # every third run all fill
        a = q * run
        hi[a:a + run], lo[a:a + run], idx[a:a + run] = -1, -1, -1
    # the signed order of hi above is not the unsigned order the records
    # use: sort each full run again as unsigned records
    for q in range(0, n_runs, 3):
        a = q * run
        h, l, i = radix.region_sort_plain(hi[a:a + run], lo[a:a + run], idx[a:a + run], run, run)
        hi[a:a + run], lo[a:a + run], idx[a:a + run] = h, l, i
    want = radix.region_sort_plain(hi, lo, idx, region, C)
    got = _merge_model((hi, lo, idx), region, C, run)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_region_merge_geometry():
    # step 2's and step 3's shapes: 8192-record chunks of 1024-record slots
    assert radix.region_merge_geometry(8192, 1024) == {
        "m": 8192, "run": 1024, "levels": 3, "P": radix.MERGE_OUTPUTS,
        "threads": 8192 // radix.MERGE_OUTPUTS, "smem_bytes": 163840}
    # a short chunk is padded to the next power of two
    assert radix.region_merge_geometry(6144, 2048)["threads"] == 8192 // radix.MERGE_OUTPUTS
    for bad in ((8192, 1000), (16384, 1024), (8192, 64), (4, 4)):
        with pytest.raises(ValueError):
            radix.region_merge_geometry(*bad)


def test_phase_kernels_take_cuda_tensors_only(rng):
    """The phase wrappers launch their kernels or raise; only
    partition_sort routes CPU tensors to the plain version."""
    planes = torch.from_numpy(_stream(rng, 2048, 4).view(np.int32))
    recs = radix.tile_sort_plain(planes, 4, 2048)
    with pytest.raises(ValueError, match="unsupported device"):
        radix.tile_sort(planes, 4, 2048)
    with pytest.raises(ValueError, match="unsupported device"):
        radix.region_sort(*recs, 2048, 1024, 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        radix.merge_pass(*recs, 2048, 1024, final=(planes, 4))


def test_geometry_and_checks():
    # JAX's default bin count, halved until cap is a multiple of 1024
    assert radix.geometry(1 << 20, 64) == (8192, 128, 16, 1024, 128 * 1024)
    assert radix.geometry(3 * 8192, 64)[:3] == (8192, 3, 8)
    with pytest.raises(ValueError):
        radix.geometry(1000, 16)
    with pytest.raises(ValueError):
        radix.geometry(1 << 20, 128)  # a tile above one block's 8192 records
    p = torch.zeros((5, 2048), dtype=torch.int32)
    with pytest.raises(ValueError):
        radix.partition_sort(p.to(torch.int64), 4, tile_rows=16)
    with pytest.raises(ValueError):
        radix.partition_sort(p, 6, tile_rows=16)


@pytest.mark.cuda
def test_radix_kernels_match_plain(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for case in ("w4", "w13_cmp4", "overflow", "ambiguous_w13"):
        make, n, w, cmp_keys, tile_rows, n_bins = CASES[case]
        planes = torch.from_numpy(make(rng, 8 * n, w).view(np.int32)).cuda()
        before = dict(tdev.LAUNCHES)
        got = radix.partition_sort(planes, w, cmp_keys, tile_rows, n_bins)
        want = radix.partition_sort_plain(planes, w, cmp_keys, tile_rows, n_bins)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for name in ("radix_tile_sort", "radix_partition", "radix_region_sort",
                     "radix_merge_pass"):
            assert tdev.LAUNCHES[name] > before[name]
    # K4a alone at cmp_keys 1-4 on odd tile counts of tie-heavy rows
    for cmp_keys, T, tiles in K4A_CASES:
        for tie_first in (False, True):
            planes = _tie_rows(rng, T * tiles, 5, cmp_keys, tie_first)
            planes = torch.from_numpy(planes.view(np.int32)).cuda()
            got = radix.tile_sort(planes, cmp_keys, T)
            want = radix.tile_sort_plain(planes, cmp_keys, T)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    # K4c alone on K4b's slots (8 runs a chunk; 3 runs padded to 4; a
    # short last chunk; one bin), as records and with the final gather
    for n, w, tile_rows, n_bins in MERGE_CASES.values():
        planes = torch.from_numpy(_stream(rng, n, w).view(np.int32)).cuda()
        T, n_tiles, nb, cap, region = radix.geometry(n, tile_rows, n_bins)
        s = radix.tile_sort(planes, 4, T)
        sp = radix.splitters(s[0], s[1], T, nb)
        *recs, over = radix.partition(planes, *s, *sp, w, 4, T, nb, cap)
        C = min(T, region)
        want = radix.region_sort_plain(*recs, region, C)
        got = radix.region_sort(*recs, region, C, min(cap, C))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = radix.region_sort(*recs, region, C, min(cap, C), final=(planes, w))
        assert torch.equal(got, radix.gather_plain(want[2], planes, w))
    # K4d alone at every level of the model's cases, as records and with
    # the final gather
    for case, (n, w, tile_rows, n_bins) in PASS_CASES.items():
        for make in (_stream, _skewed):
            recs, region, C, run = _slots(rng, n, w, tile_rows, n_bins, make)
            planes = torch.from_numpy(make(rng, n, w).view(np.int32)).cuda()
            recs = [r.cuda() for r in radix.region_sort_plain(*recs, region, C)]
            for wd in radix.merge_widths(region, C):
                want = radix.merge_pass_plain(*recs, region, wd)
                got = radix.merge_pass(*recs, region, wd)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                got = radix.merge_pass(*recs, region, wd, final=(planes, w))
                assert torch.equal(got, radix.gather_plain(want[2], planes, w))
                recs = want


def _corank_warp(A, B, a, la, b, lb, d):
    """radix.cu corank_warp for every block at once: 32 probes a step,
    the ballot's count of splits at which A[p] <= B[d-1-p] holds (a
    prefix of the lanes) keeping one gap of the stride."""
    lo_i = np.maximum(d - lb, 0)
    hi_i = np.minimum(d, la)
    lanes = np.arange(32)
    while (lo_i < hi_i).any():
        act = lo_i < hi_i
        s = np.where(act, (hi_i - lo_i + 31) // 32, 1)
        p = lo_i[:, None] + lanes[None, :] * s[:, None]
        ok = act[:, None] & (p < hi_i[:, None])
        pa = np.where(ok, a[:, None] + p, 0)
        qb = np.where(ok, b[:, None] + d[:, None] - 1 - p, 0)
        le = ok & ~_rec_less(*(x[qb] for x in B), *(x[pa] for x in A))
        t = le.sum(axis=1)
        assert (le == (lanes[None, :] < t[:, None])).all()  # a prefix: the ballot's count
        nhi = lo_i + t * s
        lo_i = np.where(act & (t > 0), lo_i + (t - 1) * s + 1, lo_i)
        hi_i = np.where(act, np.minimum(nhi, hi_i), hi_i)
    return lo_i


def _cover(g0, ln, s0, per, total):
    """stage_slice's 16-byte cover of elements [g0, g0 + ln) placed at s0:
    (shared start, global start, length) in elements, for every block."""
    c0 = g0 // per
    c1 = (g0 + ln + per - 1) // per
    ln_c = np.where(ln > 0, (c1 - c0) * per, 0)
    ss = s0 - (g0 - c0 * per)
    assert ((ss >= 0) & (ss % per == 0))[ln > 0].all()
    assert (c0 * per + ln_c <= total)[ln > 0].all()  # the cover stays in the array
    return ss, c0 * per, ln_c


def _pass_model(recs, region, width):
    """K4d as radix.cu computes it, in numpy, every block and thread at
    once: the block's outputs [o0, o1) in one pair, its two co-ranks by
    the warp search in the records, the slices staged at their index mod
    4 by 16-byte covers (which must not overlap), each thread's co-rank
    by binary search in the slices, P sequential merges from the two
    heads (an exhausted side a fill record), and the swizzled staging."""
    g = radix.merge_pass_geometry(width)
    P, T, B = g["P"], g["threads"], g["B"]
    S = g["smem_bytes"] // radix.RECORD_BYTES
    recs = [r.numpy().view(d) for r, d in zip(recs, (np.uint64, np.uint64, np.uint32))]
    total = len(recs[0])
    bpr = -(-region // B)
    blk = np.arange(total // region * bpr)
    rbase = blk // bpr * region
    o0 = blk % bpr * B
    o1 = np.minimum(o0 + B, region)
    ps = o0 // (2 * width) * (2 * width)
    assert (o1 <= ps + 2 * width).all()  # one pair a block
    la = np.minimum(width, region - ps)
    lb = np.clip(region - ps - width, 0, width)
    a, b = rbase + ps, rbase + ps + width
    d0, d1 = o0 - ps, o1 - ps
    i0 = _corank_warp(recs, recs, a, la, b, lb, d0)
    i1 = _corank_warp(recs, recs, a, la, b, lb, d1)
    na, nb, cnt = i1 - i0, (d1 - i1) - (d0 - i0), d1 - d0
    ga, gb = a + i0, b + (d0 - i0)
    sa = ga & 3
    sb = ((sa + na + 3) & ~3) + (gb & 3)
    fills = (MAX64, MAX64, FULL)
    sm = [np.full((len(blk), S), f) for f in fills]
    owner = np.zeros((len(blk), S), dtype=np.int64)
    for x, s, per in zip(recs, sm, (2, 2, 4)):
        for tag, (g0, ln, s0) in enumerate(((ga, na, sa), (gb, nb, sb)), start=1):
            ss, gs, lc = _cover(g0, ln, s0, per, total)
            rows = np.repeat(np.arange(len(blk)), lc)
            off = np.arange(lc.sum()) - np.repeat(np.cumsum(lc) - lc, lc)
            col = np.repeat(ss, lc) + off
            assert (col < S).all() and (owner[rows, col] != 3 - tag).all()
            owner[rows, col] = tag
            s[rows, col] = x[np.repeat(gs, lc) + off]
    e = np.arange(T) * P
    rb = np.arange(len(blk))[:, None]
    sa2, sb2, na2, nb2 = sa[:, None], sb[:, None], na[:, None], nb[:, None]
    lo_i = np.maximum(e[None, :] - nb2, 0)
    hi_i = np.minimum(e[None, :], na2)
    while (lo_i < hi_i).any():
        go = lo_i < hi_i
        mid = (lo_i + hi_i) >> 1
        p = np.where(go, sa2 + mid, 0)
        q = np.where(go, sb2 + e[None, :] - 1 - mid, 0)
        le = ~_rec_less(*(s[rb, q] for s in sm), *(s[rb, p] for s in sm))
        lo_i = np.where(go & le, mid + 1, lo_i)
        hi_i = np.where(go & ~le, mid, hi_i)
    i, j = lo_i, e[None, :] - lo_i
    o = [np.empty((len(blk), T, P), dtype=s.dtype) for s in sm]

    def head(k, n_, s0):
        return [np.where(k < n_, s[rb, np.where(k < n_, s0 + k, 0)], f) for s, f in zip(sm, fills)]

    for u in range(P):
        ha, hb = head(i, na2, sa2), head(j, nb2, sb2)
        take_a = ~_rec_less(*hb, *ha)
        for x, ya, yb in zip(o, ha, hb):
            x[:, :, u] = np.where(take_a, ya, yb)
        i, j = i + take_a, j + ~take_a
    k = e[:, None] + np.arange(P)[None, :]
    stage = [np.zeros((len(blk), B), dtype=s.dtype) for s in sm]
    for st, x in zip(stage, o):
        st[:, _sw(k).reshape(-1)] = x.reshape(len(blk), -1)
    out = [x.copy() for x in recs]
    for x, st in zip(out, stage):
        for q in range(len(blk)):
            x[rbase[q] + o0[q]:rbase[q] + o1[q]] = st[q, _sw(np.arange(cnt[q]))]
    return ([torch.from_numpy(out[0].view(np.int64)), torch.from_numpy(out[1].view(np.int64)),
             torch.from_numpy(out[2].view(np.int32))], o0)


PASS_CASES = {
    # (n, w, tile_rows, n_bins): levels 2048, 4096 (a partnerless last
    # run), 8192 (a short partner) of regions of 12288 records, 2048
    # outputs a block; and 128-row tiles in one bin: 8 levels from 128
    # (32 threads a block) in regions of 20480 records
    "3_levels_B2048": (12 * 2048, 5, 16, 4),
    "8_levels_from_128": (80 * 128, 4, 1, None),
}


@pytest.mark.parametrize("make", ["stream", "skewed"])
@pytest.mark.parametrize("case", list(PASS_CASES))
def test_merge_pass_model_matches_plain(rng, case, make):
    """Every merge level of a sort, through the model, against
    merge_pass_plain: slots with fill tails, short and partnerless last
    runs, and (skewed) long runs of records tied on hi and lo, settled by
    idx, across block edges."""
    n, w, tile_rows, n_bins = PASS_CASES[case]
    recs, region, C, run = _slots(rng, n, w, tile_rows, n_bins,
                                  {"stream": _stream, "skewed": _skewed}[make])
    recs = radix.region_sort_plain(*recs, region, C)
    widths = radix.merge_widths(region, C)
    assert len(widths) == {"3_levels_B2048": 3, "8_levels_from_128": 8}[case]
    assert region % widths[-1] and region < 2 * widths[-1]  # a short last run
    tied_edges = 0
    for wd in widths:
        want = radix.merge_pass_plain(*recs, region, wd)
        got, o0 = _pass_model(recs, region, wd)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        hi, lo, idx = (x.numpy() for x in want)
        starts = (np.arange(len(hi)) // region * region)[::region]
        edges = (starts[:, None] + o0[o0 > 0][None, :len(o0)]).reshape(-1)
        edges = edges[edges < len(hi)]
        tied_edges += int(((hi[edges] == hi[edges - 1]) & (lo[edges] == lo[edges - 1])
                           & (idx[edges] != -1)).sum())
        recs = want
    if make == "skewed":
        assert tied_edges > 0  # some block edge fell inside a run of ties


def test_merge_pass_geometry():
    assert radix.merge_pass_geometry(8192) == {"P": 8, "threads": 256, "B": 2048,
                                               "smem_bytes": 2064 * 20}
    assert radix.merge_pass_geometry(1 << 24)["threads"] == 256
    assert radix.merge_pass_geometry(128)["threads"] == 32
    for bad in (64, 3000):
        with pytest.raises(ValueError):
            radix.merge_pass_geometry(bad)
