"""K3 bitonic sort: the port's bitonic_sort (plain version, CPU) against
the JAX package's Pallas kernels in interpret mode, bit for bit with the
payload = row index, over tiles that differ between the two; each phase
against a numpy transcription of the network; and, on a card, every
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
