"""Pre-correction (ops/precorrect.py): the port's torch pre_correct on the
CPU against the JAX package's on the same reads, and the vote's rules on
cases built for them — equal quality sums (the first maximum wins), a
loser exactly at the 0.25 ratio, duplicate flanks (one group, stable
order) and the float32 product of the loser test.  Tolerance: exact
equality."""

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.core import dna
from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.ops import precorrect as jpc
from w2rap_contigger_tpu_torch.core.reads import ReadSet as TReadSet
from w2rap_contigger_tpu_torch.ops import precorrect as tpc
from _torch_guards import time_limited  # noqa: F401


def _both(seqs, quals):
    reads = ReadSet.from_sequences(seqs, quals)
    jb, jn = jpc.pre_correct(reads)
    tb, tn = tpc.pre_correct(TReadSet(reads.bases, reads.lengths, reads.quals),
                             device="cpu")
    np.testing.assert_array_equal(tb, jb)
    assert tn == jn
    return reads, tb, tn


def test_pre_correct_matches_jax(rng):
    """tests/test_precorrect.py's data: 60 bp reads of a 900 bp genome,
    2% errors at quality 4, half of them reverse complemented."""
    genome = rng.integers(0, 4, size=900).astype(np.uint8)
    rlen = 60
    seqs, quals = [], []
    for s in range(0, 900 - rlen, 2):
        r = genome[s : s + rlen].copy()
        q = np.full(rlen, 35, np.uint8)
        m = rng.random(rlen) < 0.02
        r[m] = (r[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
        q[m] = 4
        if rng.random() < 0.5:
            r = dna.revcomp_codes(r)
            q = q[::-1].copy()
        seqs.append(r)
        quals.append(q)
    _, _, n_fixed = _both(seqs, quals)
    assert n_fixed > 0


def _column(center_bases, center_quals, rc=()):
    """25 bp reads of one flank with the given center bases and quals;
    reads listed in rc are reverse complemented (same canonical flank).
    The flank begins and ends with A, so it is its own canonical form and
    the vote sees the center bases as given."""
    flank = np.random.default_rng(7).integers(0, 4, size=24).astype(np.uint8)
    flank[0] = flank[-1] = 0
    seqs, quals = [], []
    for i, (b, q) in enumerate(zip(center_bases, center_quals)):
        r = np.concatenate([flank[:12], [b], flank[12:]]).astype(np.uint8)
        qq = np.full(25, 30, np.uint8)
        qq[12] = q
        if i in rc:
            r = dna.revcomp_codes(r)
            qq = qq[::-1].copy()
        seqs.append(r)
        quals.append(qq)
    return seqs, quals


@pytest.mark.parametrize("case", ["tie", "ratio", "duplicates"])
def test_vote_rules(case):
    if case == "tie":
        # A and C tie at 60: A, the first maximum, wins, so the G loses
        # to A (a last-maximum rule would make it C)
        seqs, quals = _column([0, 0, 1, 1, 2, 0, 1], [30, 30, 30, 30, 5, 0, 0])
        expect = {4: 0}
    elif case == "ratio":
        # winner A 80; G's 20 is exactly 0.25 * 80 and stays, T's 19 loses
        seqs, quals = _column([0, 0, 2, 3, 0, 0], [40, 40, 20, 19, 0, 0])
        expect = {3: 0}
    else:
        # six copies of one 25-mer, two reverse complemented, and one
        # copy with a low-quality error: one group, the error loses
        seqs, quals = _column([1, 1, 1, 1, 1, 1, 3], [30, 30, 30, 30, 30, 30, 3],
                              rc=(1, 4))
        expect = {6: 1}
    reads, new_bases, n_fixed = _both(seqs, quals)
    rows, cols = np.nonzero(new_bases != reads.bases)
    assert (cols == 12).all()
    got = {int(r): int(new_bases[r, 12]) for r in rows}
    assert got == expect and n_fixed == len(expect)


def test_vote_loser_test_is_float32():
    """qwin = 2**24 + 1 rounds to 2**24 in float32: a loser of 2**22 is
    not below 0.25 * qwin there (it is in float64), so it stays."""
    big = (1 << 24) + 1
    words = torch.zeros((6, 2), dtype=torch.int64)
    center = torch.tensor([0, 1, 0, 0, 0, 0])
    qual = torch.tensor([big, 1 << 22, 0, 0, 0, 0])
    _, fix, winner = tpc._vote(words, center, qual)
    assert not bool(fix.any()) and int(winner[0]) == 0
    assert (1 << 22) < 0.25 * big  # float64 would have fixed it
    import jax.numpy as jnp

    _, jfix, _ = jpc._vote(jnp.zeros((6, 2), jnp.uint32), jnp.asarray(center.numpy(), jnp.uint32),
                           jnp.asarray(qual.numpy(), jnp.uint32), jnp.ones(6, bool))
    assert not bool(np.asarray(jfix).any())
