"""Batched multiword binary search into the sorted kmer table.

Counterpart of w2rap_contigger_tpu/ops/lookup.py:21-47 (`_search`, plain
XLA there, so a plain torch loop here): n_iters rounds of one (W, Q)
gather and a lexicographic compare, thousands of queries wide.  Replaces
the reference's KmerDict::findEntry hash probes (ReadPather.h:177).
"""

from __future__ import annotations

import math

import torch


def n_iters_for(m: int) -> int:
    """Rounds that resolve any query against an m-row table."""
    return max(1, int(math.ceil(math.log2(m + 1))))


def search(table_t: torch.Tensor, q_t: torch.Tensor, n_iters: int):
    """table_t (W, M) and q_t (W, Q) int64 u32 words, table sorted.

    Returns (idx (Q,) int64, found (Q,) bool): idx is the table row when
    found, else the insertion point clipped to M-1.  Gather indices are
    clamped to M-1 exactly as XLA clamps the JAX version's gathers.
    """
    W, M = table_t.shape
    Q = q_t.shape[1]
    dev = q_t.device
    if M == 0:
        return (torch.zeros(Q, dtype=torch.int64, device=dev),
                torch.zeros(Q, dtype=torch.bool, device=dev))
    lo = torch.zeros(Q, dtype=torch.int64, device=dev)
    hi = torch.full((Q,), M, dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        midw = table_t[:, mid.clamp(max=M - 1)]
        lt = midw[W - 1] < q_t[W - 1]
        for i in range(W - 2, -1, -1):
            lt = (midw[i] < q_t[i]) | ((midw[i] == q_t[i]) & lt)
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    idx = lo.clamp(0, M - 1)
    found = (table_t[:, idx] == q_t).all(dim=0) & (lo < M)
    return idx, found
