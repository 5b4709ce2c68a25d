"""K4 partition sort: the port's plain version against the JAX package's
Pallas kernels in interpret mode, at the JAX tests' tile_rows and n_bins
(tests/test_pallas_radix.py): splitters, overflow flag, each region's
count of valid rows and each region's rows (lexsorted by all planes, as
only the order of rows tied on the comparator words may differ); the
collision flag; the plain phases composed one by one; a numpy model of
K4c's merge path (csrc/region_merge.cu) against the plain chunk sort;
and, on a card, every kernel against its plain version.  Tolerance:
exact equality."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from w2rap_contigger_tpu.ops import pallas_radix as prad
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import radix

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


MAX64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sw(k):
    """region_merge.cu's shared-memory swizzle."""
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
