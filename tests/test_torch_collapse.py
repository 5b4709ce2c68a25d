"""K2 collapse: the port's plain version against the JAX package's Pallas
kernel in interpret mode (+ gather_unique), and the CUDA kernel against
the plain version.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from w2rap_contigger_tpu.ops import pallas_collapse as pcol
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import collapse as kcol
from w2rap_contigger_tpu_torch.ops.kmer_engine import compact_tiles

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
    table = compact_tiles(out, tile_counts, TILE).numpy().view(np.uint32)
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
