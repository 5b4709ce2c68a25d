"""Plain reference of step 2's k-mer count, written from the upstream
semantics (BuildReadQGraph.cc: count_good_lengths, then canonical k-mers
with their KMerContext, collapsed and filtered at min_freq), in plain
PyTorch on any device, in blocks of reads.

Semantics, for reads of 2-bit codes (A=0, C=1, G=2, T=3):

* A read's usable prefix (glen) ends where its last run of at least k
  bases of quality >= min_qual ends, within its length; with no such run
  it is empty.  Its windows are the k-mers starting at 0 .. glen-k, and
  only where glen > k (a prefix of exactly k bases gives none, as
  upstream's loop bound does).
* A window's k-mer is canonical: the lesser of it and its reverse
  complement as base strings; on a tie the forward one.
* Its context byte: high nibble the predecessor base (bit b for base b)
  when the window does not start the read, low nibble the successor base
  when the window ends before glen.  A window taken as its reverse
  complement takes the complemented successor as predecessor and the
  complemented predecessor as successor.
* Equal canonical k-mers collapse into one entry: count = occurrences
  saturated at 255, context = OR of the contexts.  The dictionary keeps
  count >= min_freq, in base-string order.  The histogram bins every
  distinct k-mer at min(count, 100); bin 0 is 0.

A k-mer (32 < k <= 64) is held as two int64 keys, `hi` (bases 0..31)
and `lo` (bases 32..k-1, left-aligned), each its big-endian 2-bit value
less 2**63, so that signed order is base-string order.  `keys_of_words`
gives the same keys from the program's u32 word layout.
"""

from __future__ import annotations

import torch

SAT = 255
HIST_BINS = 101
RANGE_BITS = 3  # the collapse runs on 8 ranges of hi's top bits, in order
BLOCK_READS = 16384


def good_lengths(quals: torch.Tensor, lengths: torch.Tensor, k: int, min_qual: int):
    """(N,) int64 usable prefix lengths."""
    n, L = quals.shape
    pos = torch.arange(L, device=quals.device)[None, :]
    good = (quals >= min_qual) & (pos < lengths[:, None])
    last_bad = torch.cummax(torch.where(good, -1, pos), dim=1).values
    long_run = good & (pos - last_bad >= k)  # >= k good bases end here
    next_good = torch.zeros_like(good)
    next_good[:, :-1] = good[:, 1:]
    run_end = long_run & ~next_good
    return torch.where(run_end, pos + 1, 0).max(dim=1).values.to(torch.int64)


def _key32(codes: torch.Tensor) -> torch.Tensor:
    """(..., 32) codes -> their big-endian 2-bit value less 2**63."""
    rest = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for i in range(1, 32):
        rest = rest * 4 + codes[..., i]
    return (codes[..., 0].to(torch.int64) - 2) * (1 << 62) + rest


def _keys(codes: torch.Tensor, k: int):
    """(hi, lo) of k-mers given as (..., k) codes."""
    if not 32 < k <= 64:
        raise ValueError("the reference keys take 32 < k <= 64")
    lo = torch.zeros(codes.shape[:-1] + (32,), dtype=codes.dtype, device=codes.device)
    lo[..., : k - 32] = codes[..., 32:k]
    return _key32(codes[..., :32]), _key32(lo)


def block_windows(bases: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor,
                  k: int, min_qual: int):
    """The valid windows of a block of reads: (hi, lo) int64 keys of their
    canonical k-mers and ctx, their uint8 context bytes."""
    n, L = bases.shape
    glen = good_lengths(quals, lengths.to(torch.int64), k, min_qual)
    n_win = torch.where(glen > k, glen - k + 1, 0)
    pos = torch.arange(max(L - k + 1, 0), device=bases.device)
    rows, cols = (pos[None, :] < n_win[:, None]).nonzero(as_tuple=True)
    win = bases[rows[:, None], cols[:, None] + torch.arange(k, device=bases.device)[None, :]]
    fhi, flo = _keys(win, k)
    rhi, rlo = _keys(3 - win.flip(-1), k)
    del win
    is_rev = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    hi = torch.where(is_rev, rhi, fhi)
    lo = torch.where(is_rev, rlo, flo)
    has_pred = cols > 0
    has_succ = cols + k < glen[rows]
    pred = bases[rows, (cols - 1).clamp(min=0)].to(torch.int64)
    succ = bases[rows, (cols + k).clamp(max=L - 1)].to(torch.int64)
    fwd = torch.where(has_pred, 16 << pred, 0) | torch.where(has_succ, 1 << succ, 0)
    rev = torch.where(has_succ, 16 << (3 - succ), 0) | torch.where(has_pred, 1 << (3 - pred), 0)
    return hi, lo, torch.where(is_rev, rev, fwd).to(torch.uint8)


def collapse(hi: torch.Tensor, lo: torch.Tensor, ctx: torch.Tensor, keys: str = "full"):
    """Distinct k-mers of windows, in base-string order: (hi, lo, count,
    ctx), count saturated.  keys="full" compares the whole k-mer;
    keys="hi" (the control) compares only its first 32 bases and keeps
    the least k-mer of each group."""
    if hi.numel() == 0:
        z = hi.new_zeros(0)
        return z, z, z, z
    order = torch.sort(lo, stable=True).indices
    order = order[torch.sort(hi[order], stable=True).indices]
    hi, lo, ctx = hi[order], lo[order], ctx[order].to(torch.int64)
    del order
    new = torch.ones(hi.numel(), dtype=torch.bool, device=hi.device)
    same = hi[1:] == hi[:-1]
    if keys == "full":
        same &= lo[1:] == lo[:-1]
    new[1:] = ~same
    seg = torch.cumsum(new, 0) - 1
    m = int(seg[-1]) + 1
    count = torch.zeros(m, dtype=torch.int64, device=hi.device).index_add_(
        0, seg, torch.ones_like(seg))
    cx = torch.zeros(m, dtype=torch.int64, device=hi.device)
    for bit in range(8):
        got = torch.zeros(m, dtype=torch.int64, device=hi.device).index_add_(
            0, seg, (ctx >> bit) & 1)
        cx |= (got > 0).to(torch.int64) << bit
    first = new.nonzero(as_tuple=True)[0]
    return hi[first], lo[first], count.clamp(max=SAT), cx


def count(bases, quals, lengths, k: int, min_qual: int, min_freq: int,
          device="cpu", keys: str = "full"):
    """The reference count of host arrays, on `device`: a dict of the kept
    k-mers' `hi`, `lo`, `count` and `ctx` (int64 tensors on `device`, in
    base-string order), the `hist` ((101,) int64 tensor on the host) and
    `windows`, the valid windows counted."""
    dev = torch.device(device)
    parts = []
    for r0 in range(0, bases.shape[0], BLOCK_READS):
        sl = slice(r0, r0 + BLOCK_READS)
        parts.append(block_windows(
            torch.as_tensor(bases[sl]).to(dev), torch.as_tensor(quals[sl]).to(dev),
            torch.as_tensor(lengths[sl]).to(dev), k, min_qual))
    hi, lo, ctx = (torch.cat([p[i] for p in parts]) for i in range(3))
    del parts
    windows = hi.numel()
    rng = hi >> (64 - RANGE_BITS)  # ascending with hi
    out = {"hi": [], "lo": [], "count": [], "ctx": []}
    hist = torch.zeros(HIST_BINS, dtype=torch.int64)
    for r in range(-(1 << (RANGE_BITS - 1)), 1 << (RANGE_BITS - 1)):
        sel = rng == r
        h, l, c, x = collapse(hi[sel], lo[sel], ctx[sel], keys)
        hist += torch.bincount(c.clamp(max=HIST_BINS - 1), minlength=HIST_BINS).cpu()
        keep = c >= min_freq
        for name, t in zip(("hi", "lo", "count", "ctx"), (h, l, c, x)):
            out[name].append(t[keep])
    hist[0] = 0
    res = {name: torch.cat(ts) for name, ts in out.items()}
    res["hist"] = hist
    res["windows"] = windows
    return res


def keys_of_words(words: torch.Tensor):
    """(hi, lo) keys of k-mers in the program's layout: (m, W) u32 values
    (int64), 32 < k <= 64, base b at bits 30 - 2 * (b % 16) of word b // 16."""
    w = words.to(torch.int64)
    if w.shape[1] not in (3, 4):
        raise ValueError("the reference keys take 32 < k <= 64")
    hi = (w[:, 0] - (1 << 31)) * (1 << 32) + w[:, 1]
    lo = (w[:, 2] - (1 << 31)) * (1 << 32) + (w[:, 3] if w.shape[1] == 4 else 0)
    return hi, lo
