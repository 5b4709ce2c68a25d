"""2-bit packed k-mer word operations on host numpy arrays.

The numpy half of w2rap_contigger_tpu/ops/bitkmer.py, copied so the port
imports nothing of the JAX package (the device half is ops/bitkmer.py,
on torch tensors).

Layout: a k-mer (k <= 64 here; large K uses hashed BigK, see ops.bigk) is
stored as W = ceil(k/16) uint32 words.  Word w holds bases [16w, 16w+16),
base b sits at bits (30 - 2*(b % 16)) .. (31 - 2*(b % 16)) — i.e. 2-bit
fields packed big-endian.  Consequence: unsigned lexicographic comparison
of the word tuple == lexicographic comparison of the base string, which is
what the whole sort-based dictionary relies on.

Base codes: A=0 C=1 G=2 T=3 (same as the reference's dna/Bases.h), so the
complement of code c is 3-c == c ^ 3, and complementing a packed word is
just bitwise NOT.

The reference analogue of this module is the KMer<K> template
(src/kmers/KMer.h:32,174-195); the design here is new: fixed word-lane
arrays instead of per-object packed storage, so everything vectorizes.
"""

from __future__ import annotations

import numpy as np

# numpy scalar constants (no int32 overflow in the shifts below)
M2 = np.uint32(0x33333333)
M4 = np.uint32(0x0F0F0F0F)
M8 = np.uint32(0x00FF00FF)
FULL = np.uint32(0xFFFFFFFF)
THREE = np.uint32(0x3)


def nwords(k: int) -> int:
    """Number of uint32 words used for a k-mer."""
    return (k + 15) // 16


_REV16 = None  # 2-bit-group reversal of a 16-bit half, lazy (65536 u32)


def _rev16_table():
    global _REV16
    if _REV16 is None:
        x = np.arange(65536, dtype=np.uint32)
        x = ((x & np.uint32(0x3333)) << 2) | ((x >> 2) & np.uint32(0x3333))
        x = ((x & np.uint32(0x0F0F)) << 4) | ((x >> 4) & np.uint32(0x0F0F))
        x = ((x & np.uint32(0x00FF)) << 8) | ((x >> 8) & np.uint32(0x00FF))
        _REV16 = x
    return _REV16


def revpair32(w):
    """Reverse the sixteen 2-bit groups inside each uint32."""
    # two cache-resident table gathers beat 7 full-array temporaries
    # (rc_words over multi-million-row dictionaries is a measured
    # step-2/3 host cost)
    w = np.asarray(w, dtype=np.uint32)
    t = _rev16_table()
    return (t[w & np.uint32(0xFFFF)] << np.uint32(16)) | t[w >> np.uint32(16)]


def rc_words(words, k: int):
    """Reverse-complement of packed k-mers.

    `words`: (..., W) uint32.  Returns same shape.
    """
    W = nwords(k)
    assert words.shape[-1] == W
    # bit-reverse in 2-bit groups across the whole W*32-bit string:
    # reverse groups within each word, then reverse word order; complement.
    rev = revpair32(~words & FULL)[..., ::-1]
    # now the kmer occupies the LOW 2k bits; shift left by s to re-align
    # to the top (big-endian layout keeps padding at the bottom).
    s = 2 * (16 * W - k)
    if s == 0:
        return rev
    lo = rev[..., 1:]
    hi = rev[..., :-1]
    shifted_hi = ((hi << s) | (lo >> (32 - s))) & FULL
    last = (rev[..., -1:] << s) & FULL
    return np.concatenate([shifted_hi, last], axis=-1)


def words_lt(a, b):
    """Lexicographic a < b over the last axis (word tuples). Returns bool (...)."""
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for i in range(W - 2, -1, -1):
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def words_eq(a, b):
    """a == b over the last axis."""
    eq = a[..., 0] == b[..., 0]
    for i in range(1, a.shape[-1]):
        eq = eq & (a[..., i] == b[..., i])
    return eq


def canonicalize(words, k: int):
    """Return (canonical_words, is_rev) — is_rev True when rc < fwd.

    Matches the reference's CanonicalForm: REV iff the reverse complement
    compares lexicographically smaller (BaseVec.h:325-333).  Palindromes
    (rc == fwd) report is_rev=False.
    """
    rc = rc_words(words, k)
    is_rev = words_lt(rc, words)
    canon = np.where(is_rev[..., None], rc, words)
    return canon, is_rev


def is_palindrome(words, k: int):
    """True where the k-mer equals its reverse complement (even k only)."""
    return words_eq(rc_words(words, k), words)


def to_successor(words, code, k: int):
    """Shift in base `code` at the back: kmer[1:] + code.

    `code`: scalar or broadcastable integer array of base codes.
    Reference analogue: KMer::toSuccessor (src/kmers/KMer.h:174).
    """
    W = nwords(k)
    hi = (words[..., :-1] << 2) | (words[..., 1:] >> 30)
    last = (words[..., -1:] << 2) & FULL
    out = np.concatenate([hi & FULL, last], axis=-1)
    # position of base k-1 inside word W-1:
    shift_last = 30 - 2 * ((k - 1) % 16)
    out[..., W - 1] |= np.asarray(code, dtype=np.uint32) << np.uint32(shift_last)
    # clear any bits shifted past base k-1 (only matters when k%16 != 0)
    pad = 2 * (16 * W - k)
    if pad:
        mask = (FULL >> pad) << pad
        out[..., W - 1] &= mask
    return out


def to_predecessor(words, code, k: int):
    """Shift in base `code` at the front: code + kmer[:-1]."""
    W = nwords(k)
    lo = (words[..., 1:] >> 2) | ((words[..., :-1] & THREE) << 30)
    first = words[..., :1] >> 2
    out = np.concatenate([first, lo & FULL], axis=-1)
    out[..., 0] |= np.asarray(code, dtype=np.uint32) << np.uint32(30)
    pad = 2 * (16 * W - k)
    if pad:
        mask = (FULL >> pad) << pad
        out[..., W - 1] &= mask
    return out


def first_base(words, k: int):
    """Base code of position 0."""
    return (words[..., 0] >> 30) & THREE


def last_base(words, k: int):
    """Base code of position k-1."""
    W = nwords(k)
    shift = 30 - 2 * ((k - 1) % 16)
    return (words[..., W - 1] >> shift) & THREE


def pack_codes(codes, k: int):
    """Pack (..., k) base-code array into (..., W) uint32 words (host numpy)."""
    codes = np.asarray(codes, dtype=np.uint32)
    W = nwords(k)
    padded = np.zeros(codes.shape[:-1] + (W * 16,), dtype=np.uint32)
    padded[..., :k] = codes
    padded = padded.reshape(codes.shape[:-1] + (W, 16))
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return np.bitwise_or.reduce(padded << shifts, axis=-1).astype(np.uint32)


def unpack_words(words, k: int):
    """Inverse of pack_codes: (..., W) uint32 -> (..., k) uint8 codes (host)."""
    words = np.asarray(words, dtype=np.uint32)
    W = nwords(k)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    codes = (words[..., :, None] >> shifts) & 0x3
    return codes.reshape(words.shape[:-1] + (W * 16,))[..., :k].astype(np.uint8)
