"""Reads for the pack tests (K0, `pack_glen`, against `pack_and_glen_host`):
numpy only, no JAX, so the card's test file can use them too.

`case(name)` -> (bases, quals, lengths, k, min_qual): (n, L) uint8 codes
and qualities, (n,) int32 lengths.  Every case with reads holds, besides
random reads with 2% of bases at Q2:
  - a read of length 0, and one longer than L (clamped to L);
  - a read with no run of k good bases (a bad base every k // 2), glen 0;
  - a read whose good run ends exactly at its length, with good bases
    past the length (glen = the length);
  - a read whose run is of bases at q == min_qual, broken by one base at
    min_qual - 1;
  - codes above 3 (the pack keeps their low 2 bits) in every other read.
"""

import numpy as np

MIN_QUAL = 7
# (L, k): L = 250 (the cells' reads), 16 and 32 (one and two words), L
# not a multiple of 16 (37, 300), and above 512 (600: a row longer than
# 32 words); k = 31, 60, 200, and 9 and 16 (runs inside one word)
SHAPES = ([(L, k) for L in (250, 16, 32, 37, 300) for k in (31, 60, 200)]
          + [(600, 200), (250, 9), (37, 16)])
CASE_IDS = [f"L{L}_k{k}" for L, k in SHAPES] + ["n0_L250_k60"]


def reads(seed: int, n: int, L: int, k: int):
    """n reads of L bases with the special reads of the module's list
    first (as many as n holds)."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    bases[1::2] = rng.integers(0, 256, size=bases[1::2].shape)
    quals = rng.integers(MIN_QUAL, 41, size=(n, L)).astype(np.uint8)
    quals[rng.random((n, L)) < 0.02] = 2
    lengths = rng.integers(0, L + 10, size=n).astype(np.int32)
    special = []
    # length 0; longer than L, all good
    special.append((np.full(L, 30), 0))
    special.append((np.full(L, 30), L + 5))
    # no run of k good bases
    q = np.full(L, 30)
    q[:: max(1, k // 2)] = 2
    special.append((q, L))
    # the run ends exactly at the length, good bases past it
    special.append((np.full(L, 30), min(L, k + 3)))
    # a run of bases at q == min_qual, one base below it
    q = np.full(L, MIN_QUAL)
    q[L // 3] = MIN_QUAL - 1
    special.append((q, L))
    for r, (q, length) in enumerate(special[:n]):
        quals[r] = q
        lengths[r] = length
    return bases, quals, lengths


def case(name: str):
    if name.startswith("n0_"):
        b, q, ln = reads(0, 1, 250, 60)
        return b[:0], q[:0], ln[:0], 60, MIN_QUAL
    L, k = SHAPES[CASE_IDS.index(name)]
    b, q, ln = reads(CASE_IDS.index(name) + 1, 40, L, k)
    return b, q, ln, k, MIN_QUAL


def synth_chunk(seed: int, n: int = 65536, L: int = 250):
    """One chunk of reads as scripts/make_synth_fastq.py and the
    benchmark's data make them: codes 0..3, full lengths, qualities
    30..40 with 2% at Q2."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    quals = rng.integers(30, 41, size=(n, L), dtype=np.uint8)
    quals[rng.random((n, L)) < 0.02] = 2
    return bases, quals, np.full(n, L, dtype=np.int32)
