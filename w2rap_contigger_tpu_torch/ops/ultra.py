"""ultra/ — threaded-block consensus engine.

Parity target: the reference's friend-thread consensus sub-engine
(``src/paths/long/ultra/``): ``MakeBlocks`` (``MakeBlocks.h:9-13`` —
from kmer aligns of friends onto a founder read, produce "blocks":
sequences believed true, overlapping by up to K−1, plus per-read
"threads" across the gaps between blocks), ``threaded_blocks``
(``ThreadedBlocks.h:12-40``), ``ConsensusScoreModel``
(``ConsensusScoreModel.h:28-59`` — a deletion/insertion/substitution
rate model scoring a candidate sequence against observed threads) and
``MultipleAligner``/``Prefab`` (gap consensus → corrected read).

TPU-first shape: the block/solid-column detection is a dense columnwise
reduction over the threaded stack (same layout as ops/stack.py), and
thread scoring is the batched banded DP from ops/align.py; the
candidate search (medoid + refinement) is host-side control flow over
tiny sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .align import sw_free


@dataclasses.dataclass
class ConsensusScoreModel:
    """Rate-parameterized edit scoring (ConsensusScoreModel.h:28-59):
    score(a, b) = weighted edit distance with integer costs
    −10·log10(rate) per event; lower is better."""

    del_rate: float = 0.01
    ins_rate: float = 0.01
    sub_rate: float = 0.01

    def __post_init__(self):
        self.cost_del = max(1, int(round(-10 * np.log10(self.del_rate))))
        self.cost_ins = max(1, int(round(-10 * np.log10(self.ins_rate))))
        self.cost_sub = max(1, int(round(-10 * np.log10(self.sub_rate))))

    def score(self, a, b) -> int:
        """Weighted global edit distance (DP)."""
        a = np.asarray(a, dtype=np.int8)
        b = np.asarray(b, dtype=np.int8)
        n, m = len(a), len(b)
        prev = np.arange(m + 1, dtype=np.int64) * self.cost_ins
        for i in range(1, n + 1):
            cur = np.empty(m + 1, dtype=np.int64)
            cur[0] = i * self.cost_del
            sub = np.where(a[i - 1] == b, 0, self.cost_sub)
            best = cur[0]
            diag = prev[:-1] + sub
            up = prev[1:] + self.cost_del
            for j in range(1, m + 1):
                v = min(diag[j - 1], up[j - 1], best + self.cost_ins)
                cur[j] = v
                best = v
            prev = cur
        return int(prev[m])

    def score_threads(self, candidate, threads, min_vote: int = 0) -> int:
        """Score of a candidate against all threads
        (ConsensusScoreModel.h:59)."""
        return sum(self.score(candidate, t) for t in threads)


@dataclasses.dataclass
class ThreadedBlocks:
    """blocks_ / threads_ / alive_ container (ThreadedBlocks.h:12-40).
    threads[r][g] is read r's sequence across gap g (None if the read
    does not span it); n_gaps = n_blocks - 1."""

    blocks: list
    threads: list  # threads[r][g] -> np.ndarray | None
    alive: list

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_gaps(self) -> int:
        return len(self.blocks) - 1

    def gap_threads(self, g: int):
        return [t[g] for t in self.threads if t[g] is not None]

    def gap_consensus(self, g: int, model: ConsensusScoreModel | None = None):
        """Consensus across gap g: the medoid thread (min total score to
        the other threads) refined by single-base edits while the score
        improves — the reference seeds from threads and hill-climbs
        edits (ultra/ConsensusScoreModel.h:59-106)."""
        model = model or ConsensusScoreModel()
        threads = self.gap_threads(g)
        if not threads:
            return np.zeros(0, dtype=np.int8)
        if len(threads) == 1:
            return threads[0]
        scores = [model.score_threads(t, threads) for t in threads]
        best = threads[int(np.argmin(scores))].copy()
        best_score = min(scores)
        improved = True
        while improved:
            improved = False
            for pos in range(len(best)):
                orig = best[pos]
                for b in range(4):
                    if b == orig:
                        continue
                    best[pos] = b
                    s = model.score_threads(best, threads)
                    if s < best_score:
                        best_score = s
                        orig = b
                        improved = True
                best[pos] = orig
        return best

    def assemble(self, k: int, model: ConsensusScoreModel | None = None):
        """Corrected sequence: alive blocks joined by gap consensi
        (the reference emits efasta with ambiguities; we emit the ML
        path)."""
        parts = []
        for b in range(self.n_blocks):
            if not self.alive[b]:
                continue
            parts.append(np.asarray(self.blocks[b], dtype=np.int8))
            if b < self.n_gaps:
                parts.append(np.asarray(self.gap_consensus(b, model),
                                        dtype=np.int8))
        if not parts:
            return np.zeros(0, dtype=np.int8)
        return np.concatenate(parts)


def make_blocks(founder, friends, offsets, k: int, min_cov: int = 3,
                min_agree: float = 0.9):
    """MakeBlocks (MakeBlocks.h:9-13, simplified threading): thread each
    friend onto the founder's coordinates at its offset, mark founder
    columns "solid" when >= min_cov friends cover them and >= min_agree
    of covering friends match the founder; maximal solid runs of length
    >= k become blocks, and each read contributes its sub-sequence
    between consecutive blocks as a gap thread.

    founder: (L,) codes; friends: list of code arrays; offsets[i] is
    friend i's start in founder coordinates (from kmer aligns).
    Returns a ThreadedBlocks.
    """
    founder = np.asarray(founder, dtype=np.int8)
    L = len(founder)
    cov = np.zeros(L, dtype=np.int64)
    agree = np.zeros(L, dtype=np.int64)
    for f, off in zip(friends, offsets):
        f = np.asarray(f, dtype=np.int8)
        s, e = max(0, off), min(L, off + len(f))
        if e <= s:
            continue
        seg = f[s - off:e - off]
        cov[s:e] += 1
        agree[s:e] += (seg == founder[s:e])
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(cov > 0, agree / np.maximum(cov, 1), 0.0)
    solid = (cov >= min_cov) & (frac >= min_agree)
    # maximal solid runs >= k -> blocks
    blocks, spans = [], []
    i = 0
    while i < L:
        if solid[i]:
            j = i
            while j < L and solid[j]:
                j += 1
            if j - i >= k:
                blocks.append(founder[i:j].copy())
                spans.append((i, j))
            i = j
        else:
            i += 1
    n_gaps = max(0, len(blocks) - 1)
    threads = []
    all_reads = [(founder, 0)] + list(zip(friends, offsets))
    for f, off in all_reads:
        f = np.asarray(f, dtype=np.int8)
        row = []
        for g in range(n_gaps):
            gs, ge = spans[g][1], spans[g + 1][0]  # founder coords of gap
            # the read must span the whole gap plus one anchor base
            rs, re = gs - off, ge - off
            if rs >= 1 and re <= len(f) - 1:
                row.append(f[rs:re].copy())
            else:
                row.append(None)
        threads.append(row)
    return ThreadedBlocks(blocks=blocks, threads=threads,
                          alive=[True] * len(blocks))


def prefab_correct(founder, friends, offsets, k: int,
                   model: ConsensusScoreModel | None = None):
    """Prefab-style correction (ultra/Prefab.cc): blocks + gap consensus
    reassembled into a corrected read; falls back to the founder when no
    block survives."""
    tb = make_blocks(founder, friends, offsets, k)
    if tb.n_blocks == 0:
        return np.asarray(founder, dtype=np.int8)
    return tb.assemble(k, model)
