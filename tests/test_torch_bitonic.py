"""K3 bitonic sort: the port's bitonic_sort (plain version, CPU) against
the JAX package's Pallas kernels in interpret mode, bit for bit with the
payload = row index, over tiles that differ between the two; each phase
against a numpy transcription of the network; a numpy model of the
key-index schedule (csrc/keyindex_net.cuh) of K3a against the plain tile
sort and of K3b against the plain merge level; and, on a card, every
kernel against its plain version.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from w2rap_contigger_tpu.ops import pallas_sort as ps
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import bitonic

FULL = np.uint32(0xFFFFFFFF)


def _planes(rng, n, num_keys):
    """(num_keys + 1, n) u32: key words from a few values, half of them
    >= 2^31 (many ties, unsigned order matters), 10% sentinel rows; the
    payload is the row index."""
    vals = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, FULL],
                    dtype=np.uint32)
    keys = vals[rng.integers(0, len(vals), size=(num_keys, n))]
    keys[:, rng.random(n) < 0.1] = FULL
    return np.concatenate([keys, np.arange(n, dtype=np.uint32)[None]])


def _torch(planes):
    return torch.from_numpy(np.ascontiguousarray(planes).view(np.int32))


def _np(t):
    return t.numpy().view(np.uint32)


def _network(planes, num_keys, stages):
    """The canonical network in numpy: pair (i, i+s) with i & s == 0,
    swapped iff (row i > row i+s, unsigned lexicographic) XOR (i & size)."""
    x = planes.copy()
    i = np.arange(x.shape[1])
    for s, size in stages:
        lo = i[(i & s) == 0]
        hi = lo + s
        a, b = x[:, lo], x[:, hi]
        gt = np.zeros(len(lo), bool)
        eq = np.ones(len(lo), bool)
        for j in range(num_keys):
            gt |= eq & (a[j] > b[j])
            eq &= a[j] == b[j]
        swap = gt ^ ((lo & size) != 0)
        x[:, lo[swap]], x[:, hi[swap]] = b[:, swap], a[:, swap]
    return x


def _levels(lo, hi):
    return [1 << e for e in range(lo.bit_length() - 1, hi.bit_length())]


# (n, JAX tile_rows, port tile_rows): the tiles differ in every case; n
# is one port tile in the first (the default tile), one JAX tile in the
# last
SORT_CASES = [(256, 1, None), (512, 2, 1), (1024, 8, 2)]


@pytest.mark.parametrize("n,jax_tile_rows,tile_rows", SORT_CASES)
def test_bitonic_sort_matches_jax(rng, n, jax_tile_rows, tile_rows):
    planes = _planes(rng, n, 3)
    want = ps.bitonic_sort([jnp.asarray(p) for p in planes], num_keys=3,
                           tile_rows=jax_tile_rows, interpret=True)
    want = np.stack([np.asarray(p) for p in want])
    x = _torch(planes.copy())
    assert bitonic.bitonic_sort(x, 3, tile_rows=tile_rows) is x  # in place
    got = _np(x)
    np.testing.assert_array_equal(got, want)
    # sorted (a stable lexsort leaves sorted keys in place), sentinels
    # last, every row whole
    np.testing.assert_array_equal(np.lexsort(got[2::-1]), np.arange(n))
    np.testing.assert_array_equal(planes[:, got[3]], got)
    n_sent = int((planes[:3] == FULL).all(axis=0).sum())
    assert (got[:3, n - n_sent:] == FULL).all()


def test_phases_match_the_numpy_network(rng):
    n, T, num_keys = 2048, 256, 2
    planes = _planes(rng, n, num_keys)
    tile_st = [(s, lv) for lv in _levels(2, T) for s in reversed(_levels(1, lv // 2))]
    got = bitonic.tile_sort_plain(_torch(planes), num_keys, T)
    np.testing.assert_array_equal(_np(got), _network(planes, num_keys, tile_st))
    for s, size in ((256, 512), (512, 2048), (1024, 2048)):
        got = bitonic.cross_stage_plain(_torch(planes), num_keys, s, size)
        np.testing.assert_array_equal(_np(got), _network(planes, num_keys, [(s, size)]))
    for size in (512, 2048):
        merge_st = [(s, size) for s in reversed(_levels(1, T // 2))]
        got = bitonic.merge_level_plain(_torch(planes), num_keys, T, size)
        np.testing.assert_array_equal(_np(got), _network(planes, num_keys, merge_st))
    # the phases in order are the whole network, whatever the tile
    whole = [(s, lv) for lv in _levels(2, n) for s in reversed(_levels(1, lv // 2))]
    want = _network(planes, num_keys, whole)
    for tile_rows in (1, 2, 16):
        x = _torch(planes)
        for kind, a, size in bitonic.phases(n, tile_rows * 128):
            fn = {"tile": lambda p: bitonic.tile_sort_plain(p, num_keys, a),
                  "cross": lambda p: bitonic.cross_stage_plain(p, num_keys, a, size),
                  "merge": lambda p: bitonic.merge_level_plain(p, num_keys, a, size)}[kind]
            x = fn(x)
        np.testing.assert_array_equal(_np(x), want)


def _key_index_net(tile, nwords, R, g0, levels, by_row=False):
    """The network of keyindex_net.cuh on one tile, in numpy, every thread
    of a block at once: thread t holds positions t*R .. t*R + R-1 as (tile
    row, first word); strides >= 32R exchange indices through shared
    memory and re-read the first word from the tile, strides R..16R
    exchange both between lanes of a warp, strides < R stay in the
    thread; a tie on the first word reads the later words through the
    indices, unless both rows carry the flag set at the load (all ones
    in the nwords words), which makes them equal, or with by_row (K4a)
    orders them by tile row, as it orders rows equal on every word.
    tile: (>= nwords, T) u32, read-only; g0: (threads,) the position
    whose bits give the direction of each thread's r = 0; levels: (size,
    first stride) in order.  Returns the final tile rows (threads, R) and
    the stages by kind."""
    T = tile.shape[1]
    threads = T // R
    assert threads % 32 == 0 and threads <= 1024
    t = np.arange(threads)
    ix = t[:, None] * R + np.arange(R)
    key = tile[0][ix]
    sent = (tile[:nwords] == FULL).all(axis=0)
    stages = {"smem": 0, "shfl": 0, "reg": 0}

    def swaps(ka, ia, kb, ib, desc):
        gt = ka > kb
        both = sent[ia] & sent[ib]
        tied = (ka == kb) & ~both
        for j in range(1, nwords):
            x, y = tile[j][ia], tile[j][ib]
            gt = np.where(tied & (x != y), x > y, gt)
            tied &= x == y
        if by_row:
            gt = np.where((ka == kb) & (tied | both), ia > ib, gt)
        return gt != desc

    def exchange(pk, pi, m, size):
        upper = ((t & m) != 0)[:, None]
        desc = ((g0[:, None] + np.arange(R)) & size) != 0
        assert (desc == desc[:, :1]).all()  # the kernel takes it once a stage
        sw = np.where(upper, swaps(pk, pi, key, ix, desc), swaps(key, ix, pk, pi, desc))
        return np.where(sw, pk, key), np.where(sw, pi, ix)

    for size, stride in levels:
        while stride >= 32 * R:
            m = stride // R
            pi = ix[t ^ m]  # the partner thread's indices
            key, ix = exchange(tile[0][pi], pi, m, size)
            stages["smem"] += 1
            stride //= 2
        while stride >= R:
            m = stride // R
            assert ((t ^ m) // 32 == t // 32).all()  # a lane of the same warp
            key, ix = exchange(key[t ^ m], ix[t ^ m], m, size)
            stages["shfl"] += 1
            stride //= 2
        s = R // 2
        while s > 0:
            if s <= stride:
                for r in range(R):
                    if r & s:
                        continue
                    desc = ((g0 + r) & size) != 0
                    sw = swaps(key[:, r], ix[:, r], key[:, r + s], ix[:, r + s], desc)
                    for a in (key, ix):
                        a[:, r], a[:, r + s] = (np.where(sw, a[:, r + s], a[:, r]),
                                                np.where(sw, a[:, r], a[:, r + s]))
                stages["reg"] += 1
            s //= 2
    assert np.array_equal(key, tile[0][ix])
    assert np.array_equal(np.sort(ix.reshape(-1)), np.arange(T))
    return ix, stages


def _key_index_model(planes, num_keys, T, size=None):
    """K3a (size None: levels 2..T) or K3b (the one merge level size > T:
    strides T/2..1) as the kernels compute them: the network on every
    tile, the direction from the global row, the planes stored once
    through the final indices.  Returns the planes and the stages a
    tile."""
    num_ops, n = planes.shape
    g = bitonic.tile_geometry(T, num_ops)
    R = g["R"]
    assert g["threads"] * R == T
    if size is None:
        levels = [(lv, lv // 2) for lv in _levels(2, T)]
    else:
        assert size > T
        levels = [(size, T // 2)]
    out = planes.copy()
    for base in range(0, n, T):
        tile = planes[:, base:base + T]
        g0 = base + np.arange(T // R) * R
        ix, stages = _key_index_net(tile, num_keys, R, g0, levels)
        out[:, base:base + T] = tile[:, ix.reshape(-1)]
    lt = T.bit_length() - 1
    assert sum(stages.values()) == (lt * (lt + 1) // 2 if size is None else lt)
    return out, stages


def _tie_planes(rng, n, num_keys, tie_first):
    """Tie-heavy rows (8 key values, 10% sentinels), with 90% of rows
    sharing their first word when tie_first."""
    planes = _planes(rng, n, num_keys)
    if tie_first:
        planes[0, rng.random(n) < 0.9] = 0x80000000
    return planes


# (key words, tile T, tiles): R = 2 at T <= 2048, 4 at 4096, 8 at 8192,
# 16 at 16384
MODEL_CASES = [(1, 16384, 2), (2, 128, 4), (4, 8192, 2), (4, 4096, 2), (17, 2048, 2)]


@pytest.mark.parametrize("num_keys,T,tiles", MODEL_CASES)
def test_key_index_model_matches_plain(rng, num_keys, T, tiles):
    """On tie-heavy rows (8 key values, 10% sentinels) and on rows of which
    90% share their first word."""
    for tie_first in (False, True):
        planes = _tie_planes(rng, T * tiles, num_keys, tie_first)
        got, stages = _key_index_model(planes, num_keys, T)
        np.testing.assert_array_equal(got, _np(bitonic.tile_sort_plain(_torch(planes), num_keys, T)))
    # the kernel's barriers: one a stage with a stride >= 32R
    if (num_keys, T) == (4, 8192):
        assert stages == {"smem": 15, "shfl": 40, "reg": 36}


# (key words, tile T): R = 2 at T = 128 and 2048, 8 at 8192 (where 17
# key words + payload do not fit one block)
MERGE_MODEL_CASES = [(1, 128), (4, 128), (17, 128), (1, 2048), (4, 2048), (17, 2048),
                     (1, 8192), (4, 8192)]


@pytest.mark.parametrize("num_keys,T", MERGE_MODEL_CASES)
def test_key_index_merge_model_matches_plain(rng, num_keys, T):
    """K3b's schedule against merge_level_plain on four tiles, at level 2T
    (the direction bit set in tiles 2 and 3) and 4T (set in none), on
    tie-heavy rows and on rows 90% tied on their first word."""
    for tie_first in (False, True):
        planes = _tie_planes(rng, 4 * T, num_keys, tie_first)
        for size in (2 * T, 4 * T):
            got, stages = _key_index_model(planes, num_keys, T, size)
            want = bitonic.merge_level_plain(_torch(planes), num_keys, T, size)
            np.testing.assert_array_equal(got, _np(want))
    lt = T.bit_length() - 1
    R = bitonic.tile_geometry(T, num_keys + 1)["R"]
    assert stages["reg"] == R.bit_length() - 1 and sum(stages.values()) == lt
    if T == 8192:  # 5 barriers, where the old kernel had one a stride
        assert stages == {"smem": 5, "shfl": 5, "reg": 3}


def test_checks_and_tiles():
    for bad in (torch.zeros((3, 1000), dtype=torch.int32),
                torch.zeros((3, 64), dtype=torch.int32),
                torch.zeros((3, 1024), dtype=torch.int64)):
        with pytest.raises(ValueError):
            bitonic.bitonic_sort(bad, 2)
    with pytest.raises(ValueError):
        bitonic.bitonic_sort(torch.zeros((3, 1024), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        bitonic.bitonic_sort(torch.zeros((3, 1024), dtype=torch.int32), 2, tile_rows=3)
    # the largest power of two of rows in 160 KB, never above n
    assert bitonic.tile_rows_of(5, 1 << 28) == 8192
    assert bitonic.tile_rows_of(18, 1 << 23) == 2048
    assert bitonic.tile_rows_of(3, 1 << 20) == 8192
    assert bitonic.tile_rows_of(5, 1024) == 1024
    assert bitonic.tile_rows_of(5, 1 << 20, tile_rows=4) == 512
    # K3a's launch geometry at the main path's tiles
    assert bitonic.tile_geometry(8192, 5) == {"R": 8, "threads": 1024, "smem_bytes": 196608}
    assert bitonic.tile_geometry(2048, 18) == {"R": 2, "threads": 1024, "smem_bytes": 155648}
    assert bitonic.tile_geometry(512, 41)["threads"] == 256
    assert bitonic.tile_geometry(4096, 3) == {"R": 4, "threads": 1024, "smem_bytes": 65536}
    for T, ops in ((32, 2), (32768, 1), (8192, 7)):
        with pytest.raises(ValueError):
            bitonic.tile_geometry(T, ops)
    # the phase wrappers launch their kernels or raise
    p = torch.zeros((3, 1024), dtype=torch.int32)
    for call in (lambda: bitonic.tile_sort(p, 2, 512),
                 lambda: bitonic.cross_stage(p, 2, 512, 1024),
                 lambda: bitonic.merge_level(p, 2, 512, 1024)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.cuda
def test_bitonic_kernels_match_plain(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for n, num_keys, tile_rows in ((1 << 16, 4, None), (1 << 15, 17, None), (4096, 2, 1)):
        planes = _torch(_planes(rng, n, num_keys)).cuda()
        T = bitonic.tile_rows_of(planes.shape[0], n, tile_rows)
        before = dict(tdev.LAUNCHES)
        # every wrapper sorts a copy of planes in place
        assert torch.equal(bitonic.tile_sort(planes.clone(), num_keys, T),
                           bitonic.tile_sort_plain(planes, num_keys, T))
        assert torch.equal(bitonic.cross_stage(planes.clone(), num_keys, T, 2 * T),
                           bitonic.cross_stage_plain(planes, num_keys, T, 2 * T))
        assert torch.equal(bitonic.merge_level(planes.clone(), num_keys, T, 2 * T),
                           bitonic.merge_level_plain(planes, num_keys, T, 2 * T))
        got = bitonic.bitonic_sort(planes.clone(), num_keys, tile_rows)
        assert torch.equal(got, bitonic.bitonic_sort_plain(planes, num_keys, tile_rows))
        for name in ("bitonic_tile_sort", "bitonic_cross_stage", "bitonic_merge"):
            assert tdev.LAUNCHES[name] > before[name]
    # K3a and K3b alone at every width the CLI reaches and every tile that
    # fits, on tie-heavy rows and on rows 90% tied on their first word
    for num_keys in (2, 4, 13, 17, 40):
        for T in (128 << i for i in range(7)):
            try:
                bitonic.tile_geometry(T, num_keys + 1)
            except ValueError:
                break
            for tie_first in (False, True):
                planes = _torch(_tie_planes(rng, 4 * T, num_keys, tie_first)).cuda()
                assert torch.equal(bitonic.tile_sort(planes.clone(), num_keys, T),
                                   bitonic.tile_sort_plain(planes, num_keys, T))
                for size in (2 * T, 4 * T):
                    assert torch.equal(bitonic.merge_level(planes.clone(), num_keys, T, size),
                                       bitonic.merge_level_plain(planes, num_keys, T, size))
