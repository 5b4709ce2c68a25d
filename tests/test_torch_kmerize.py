"""K1 kmerize: the port's plain version against the JAX package's Pallas
kernel in interpret mode (k = 60, 200) and its XLA `kmerize_chunk`
(k = 320, 640: W = 20 and 40, beyond the Pallas tests' reach), and the
CUDA kernel against the plain version.

Row orders differ by design (the port emits row r*P + p, the TPU kernel a
position permutation), so rows are compared as sorted multisets of
(words, ctx).  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from w2rap_contigger_tpu.ops import bitkmer as hbk
from w2rap_contigger_tpu.ops import kmer_engine as hke
from w2rap_contigger_tpu.ops import pallas_kmer as pk
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import kmerize as kkm


def _reads(rng, n, L):
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, size=n).astype(np.int32)
    quals = rng.integers(7, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.005] = 3  # low-quality bases gate glen
    return bases, lengths, quals


def _sorted_rows(words, ctx):
    rows = np.concatenate([words, ctx[:, None]], axis=1).astype(np.uint32)
    order = np.lexsort(tuple(rows[:, c] for c in range(rows.shape[1] - 1, -1, -1)))
    return rows[order]


@pytest.mark.parametrize("k", [60, 200])
def test_kmerize_plain_matches_pallas(rng, k):
    n, L = 1024, 250
    bases, lengths, quals = _reads(rng, n, L)
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, k, 7)
    W = hbk.nwords(k)
    jw, jctx, _ = pk.kmerize_packed_pallas(
        jnp.asarray(pr), jnp.asarray(glen), L, k, interpret=True
    )
    planes = kkm.kmerize(
        torch.from_numpy(pr.view(np.int32)), torch.from_numpy(glen), k, L
    )
    assert planes.shape == (W + 1, n * (L - k + 1))
    got = planes.numpy().view(np.uint32)
    jw = np.asarray(jw)
    jctx = np.asarray(jctx)
    # the TPU kernel pads positions to 16*ceil(P/16): drop its extra sentinels
    n_extra = jw.shape[0] - got.shape[1]
    sent = np.all(jw == 0xFFFFFFFF, axis=1)
    assert n_extra >= 0 and sent.sum() >= n_extra
    assert (got[:W] != 0xFFFFFFFF).any(axis=0).sum() == (~sent).sum() > 0
    j_rows = _sorted_rows(jw, jctx)[: got.shape[1]]
    p_rows = _sorted_rows(got[:W].T, got[W])
    np.testing.assert_array_equal(p_rows, j_rows)


@pytest.mark.parametrize("k,L", [(320, 340), (640, 660)])
def test_kmerize_plain_matches_xla_wide(rng, k, L):
    """W = 20 and 40 (the CLI's largest K): reads of L..k/2 bases, rare
    low-quality bases, against the JAX package's kmerize_chunk."""
    n = 24
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(k // 2, L + 1, size=n).astype(np.int32)
    lengths[: n // 3] = L
    quals = rng.integers(7, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.0005] = 3
    jw, jctx, jvalid = hke.kmerize_chunk(
        jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(quals), k=k, min_qual=7
    )
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, k, 7)
    planes = kkm.kmerize(
        torch.from_numpy(pr.view(np.int32)), torch.from_numpy(glen), k, L
    )
    W = hbk.nwords(k)
    assert planes.shape == (W + 1, n * (L - k + 1))
    got = planes.numpy().view(np.uint32)
    jw = np.asarray(jw)
    assert (got[:W] != 0xFFFFFFFF).any(axis=0).sum() == np.asarray(jvalid).sum() > 0
    np.testing.assert_array_equal(
        _sorted_rows(got[:W].T, got[W]), _sorted_rows(jw, np.asarray(jctx))
    )


def test_pack_host_matches_numpy(rng):
    bases, lengths, quals = _reads(rng, 300, 250)
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, 60, 7)
    np.testing.assert_array_equal(pr, kkm.pack_rows_host(bases))
    np.testing.assert_array_equal(glen, kkm.good_lengths_host(quals, lengths, 60, 7))


def test_kmerize_checks_inputs():
    pr = torch.zeros((4, 16), dtype=torch.int32)
    gl = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kkm.kmerize(pr.to(torch.int64), gl, 60, 250)
    with pytest.raises(ValueError):
        kkm.kmerize(pr, gl, 60, 300)  # 16 words cannot hold 300 bases
    with pytest.raises(ValueError):
        kkm.kmerize(pr, gl, 300, 250)
    # W = 41 is past the kernel's reach (k <= 640), on either path
    pr44 = torch.zeros((4, 44), dtype=torch.int32)
    for fn in (kkm.kmerize, kkm.kmerize_plain):
        with pytest.raises(ValueError, match="W=1..40"):
            fn(pr44, gl, 641, 700)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 60, 200, 272, 320, 640])
def test_kmerize_kernel_matches_plain(rng, k):
    """W = 2..40 on 4097 reads (not a multiple of 4: the planes are not
    16-byte aligned unless P is) and on 4096 (aligned), some shorter than k."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    L = max(250, k + 60)
    n = 4097
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(k // 2, L + 1, size=n).astype(np.int32)
    quals = rng.integers(7, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.0005] = 3
    pr, glen = kkm.pack_and_glen_host(bases, quals, lengths, k, 7)
    assert (glen < k).any() and (glen > k).any()
    pr_d = torch.from_numpy(pr.view(np.int32)).cuda()
    gl_d = torch.from_numpy(glen).cuda()
    for rows in (n, n - 1):
        before = tdev.LAUNCHES["kmerize"]
        got = kkm.kmerize(pr_d[:rows], gl_d[:rows], k, L)
        assert tdev.LAUNCHES["kmerize"] == before + 1
        assert torch.equal(got, kkm.kmerize_plain(pr_d[:rows], gl_d[:rows], k, L))
