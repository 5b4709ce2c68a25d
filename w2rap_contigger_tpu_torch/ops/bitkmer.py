"""2-bit packed k-mer word operations on torch tensors.

Counterpart of w2rap_contigger_tpu/ops/bitkmer.py:52-226.  Same layout:
a k-mer is W = ceil(k/16) u32 words, base b at bits 30-2*(b%16) of word
b//16 (big-endian 2-bit fields), so lexicographic word order equals base
string order.  Tensors here are int64 carrying u32 values (the package's
u32 convention); every result is masked back into [0, 2**32).
"""

from __future__ import annotations

import torch

FULL = 0xFFFFFFFF
M2 = 0x33333333
M4 = 0x0F0F0F0F
M8 = 0x00FF00FF
SIGN = 0x80000000


def nwords(k: int) -> int:
    """Number of u32 words used for a k-mer."""
    return (k + 15) // 16


def from_raw32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of raw u32 bits -> int64 tensor of u32 values."""
    return x.to(torch.int64) & FULL


def to_raw32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return (x - ((x & SIGN) << 1)).to(torch.int32)


def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of the u32 pair (hi, lo)."""
    return ((hi ^ SIGN) << 32) | lo


def revpair32(w: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups inside each u32."""
    w = ((w & M2) << 2) | ((w >> 2) & M2)
    w = ((w & M4) << 4) | ((w >> 4) & M4)
    w = ((w & M8) << 8) | ((w >> 8) & M8)
    return ((w << 16) | (w >> 16)) & FULL


def rc_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers, words (..., W)."""
    W = nwords(k)
    assert words.shape[-1] == W
    rev = revpair32(~words & FULL).flip(-1)
    s = 2 * (16 * W - k)
    if s == 0:
        return rev
    hi = ((rev[..., :-1] << s) | (rev[..., 1:] >> (32 - s))) & FULL
    last = (rev[..., -1:] << s) & FULL
    return torch.cat([hi, last], dim=-1)


def words_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last axis."""
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for i in range(W - 2, -1, -1):
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def words_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b over the last axis."""
    return (a == b).all(dim=-1)


def canonicalize(words: torch.Tensor, k: int):
    """(canonical words, is_rev): is_rev where rc < fwd (BaseVec.h:325)."""
    rc = rc_words(words, k)
    is_rev = words_lt(rc, words)
    return torch.where(is_rev[..., None], rc, words), is_rev


def is_palindrome(words: torch.Tensor, k: int) -> torch.Tensor:
    """True where the k-mer equals its reverse complement."""
    return words_eq(rc_words(words, k), words)


def _pad_mask(k: int) -> int:
    pad = 2 * (16 * nwords(k) - k)
    return ((FULL >> pad) << pad) if pad else FULL


def to_successor(words: torch.Tensor, code, k: int) -> torch.Tensor:
    """kmer[1:] + code (KMer::toSuccessor, src/kmers/KMer.h:174); code a
    Python int or an int64 tensor (an int is no host-to-device copy)."""
    hi = ((words[..., :-1] << 2) | (words[..., 1:] >> 30)) & FULL
    last = (words[..., -1:] << 2) & FULL
    out = torch.cat([hi, last], dim=-1)
    shift_last = 30 - 2 * ((k - 1) % 16)
    out[..., -1] = (out[..., -1] | (code << shift_last)) & _pad_mask(k)
    return out


def to_predecessor(words: torch.Tensor, code, k: int) -> torch.Tensor:
    """code + kmer[:-1]; code as in to_successor."""
    lo = ((words[..., 1:] >> 2) | ((words[..., :-1] & 3) << 30)) & FULL
    first = words[..., :1] >> 2
    out = torch.cat([first, lo], dim=-1)
    out[..., 0] = out[..., 0] | (code << 30)
    out[..., -1] = out[..., -1] & _pad_mask(k)
    return out


def last_base(words: torch.Tensor, k: int) -> torch.Tensor:
    """Base code of position k-1."""
    shift = 30 - 2 * ((k - 1) % 16)
    return (words[..., nwords(k) - 1] >> shift) & 3


def kmer_windows(packed: torch.Tensor, k: int, n_pos: int) -> torch.Tensor:
    """Packed kmer words of every window (kmer_engine.py:80-119).

    packed: (N, WR) int64 u32 rows; returns (N, n_pos, W) where window p
    covers bases [p, p+k).  Word j of window p is the funnel shift of
    packed words q+j and q+j+1 (q = p // 16) left by 2*(p % 16).
    """
    n, WR = packed.shape
    W = nwords(k)
    need = (n_pos + 15) // 16 + W + 1
    if WR < need:
        packed = torch.cat(
            [packed, packed.new_zeros((n, need - WR))], dim=1
        )
    p = torch.arange(n_pos, device=packed.device)
    q = p >> 4
    s = (2 * (p & 15))[None, :]
    out = []
    for j in range(W):
        hi = packed[:, q + j]
        lo = packed[:, q + j + 1]
        out.append(((hi << s) | (lo >> (32 - s))) & FULL)
    words = torch.stack(out, dim=-1)
    words[..., -1] &= _pad_mask(k)
    return words
