"""Alignment value classes — the PackAlign/Alignment layer.

Reference: src/PackAlign.h.  An alignment between two sequences is
(pos1, pos2) start positions plus alternating blocks
(gap(0), length(0), gap(1), length(1), ...) where gap > 0 inserts on
the first sequence and gap < 0 on the second (PackAlign.h:15-41).
`align` keeps plain int vectors; `packalign` packs the same content
into uint32 words with tiered storage (PackAlign.h:44-115):

  type 0: pos1,pos2 <= 1023, nblocks <= 6, lengths <= 1023,
          |gap| <= 2                      -> 3 words (12 bytes)
  type 2: general                         -> 3 + 2*nblocks words

(the reference's type 1 is an intermediate tier; the two tiers here
cover its full value domain, and `unpack` round-trips both).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Align:
    """Uncompressed forward alignment (class align, PackAlign.h:117)."""

    pos1: int
    pos2: int
    gaps: list  # gaps[i] precedes lengths[i]; gaps[0] almost always 0
    lengths: list

    @property
    def nblocks(self) -> int:
        return len(self.lengths)

    def extent1(self) -> int:
        """End position on sequence 1 (Pos1 in the reference)."""
        p = self.pos1
        for g, l in zip(self.gaps, self.lengths):
            if g < 0:
                p += -g
            p += l
        return p

    def extent2(self) -> int:
        p = self.pos2
        for g, l in zip(self.gaps, self.lengths):
            if g > 0:
                p += g
            p += l
        return p

    def flip(self) -> "Align":
        """Swap the two sequences (align::Flip): gaps negate."""
        return Align(
            self.pos2, self.pos1, [-g for g in self.gaps], list(self.lengths)
        )

    def errors(self, s1, s2) -> int:
        """Mismatches within blocks + |gap| bases (ActualErrors with
        unit penalties)."""
        e = 0
        p1, p2 = self.pos1, self.pos2
        for g, l in zip(self.gaps, self.lengths):
            if g > 0:
                p2 += g
                e += g
            elif g < 0:
                p1 += -g
                e += -g
            a = np.asarray(s1[p1 : p1 + l])
            b = np.asarray(s2[p2 : p2 + l])
            e += int(np.sum(a != b))
            p1 += l
            p2 += l
        return e

    @staticmethod
    def from_ops(pos1: int, pos2: int, ops) -> "Align":
        """Build from a traceback op string/list over {'M','I','D'}:
        M advances both, I consumes seq1 only (gap on seq2, negative),
        D consumes seq2 only (gap on seq1, positive)."""
        blocks = []  # (gap, length) with the gap preceding the length
        cur_gap = 0
        cur_len = 0
        in_gap = True
        for op in ops:
            if op == "M":
                cur_len += 1
                in_gap = False
                continue
            d = -1 if op == "I" else 1
            if not in_gap:
                blocks.append((cur_gap, cur_len))
                cur_gap = 0
                cur_len = 0
                in_gap = True
            if cur_gap != 0 and (d > 0) != (cur_gap > 0):
                # gap direction flips without an intervening match:
                # emit a zero-length block boundary
                blocks.append((cur_gap, 0))
                cur_gap = 0
            cur_gap += d
        blocks.append((cur_gap, cur_len))
        return Align(
            pos1, pos2, [g for g, _ in blocks], [l for _, l in blocks]
        )


def pack(a: Align) -> np.ndarray:
    """align -> packalign uint32 words (tiered storage)."""
    small = (
        0 <= a.pos1 <= 1023
        and 0 <= a.pos2 <= 1023
        and a.nblocks <= 6
        and all(0 <= l <= 1023 for l in a.lengths)
        and all(abs(g) <= 2 for g in a.gaps)
    )
    if small:
        # type 0 (16 bytes): w0 = [tag:4 | pos1:10 | pos2:10 | nblocks:3],
        # w1 = lengths 0..2 (10 bits each), w2 = lengths 3..5,
        # w3 = gaps as 3-bit biased fields (gap+2, 6 x 3 = 18 bits)
        w0 = (0 << 28) | (a.pos1 << 18) | (a.pos2 << 8) | a.nblocks
        w1 = 0
        for i, l in enumerate(a.lengths[:3]):
            w1 |= l << (10 * i)
        w2 = 0
        for i, l in enumerate(a.lengths[3:6]):
            w2 |= l << (10 * i)
        gbits = 0
        for i, g in enumerate(a.gaps[:6]):
            gbits |= (g + 2) << (3 * i)
        return np.asarray([w0, w1, w2, gbits], dtype=np.uint32)
    words = [np.uint32(2 << 28), np.uint32(a.pos1), np.uint32(a.pos2),
             np.uint32(a.nblocks)]
    for g, l in zip(a.gaps, a.lengths):
        words.append(np.uint32(g & 0xFFFFFFFF))
        words.append(np.uint32(l))
    return np.asarray(words, dtype=np.uint32)


def unpack(words) -> Align:
    """packalign words -> align."""
    words = np.asarray(words, dtype=np.uint32)
    tag = int(words[0]) >> 28
    if tag == 0:
        w0, w1, w2, gbits = (int(x) for x in words[:4])
        pos1 = (w0 >> 18) & 0x3FF
        pos2 = (w0 >> 8) & 0x3FF
        nblocks = w0 & 0x7
        lengths = []
        for i in range(min(nblocks, 3)):
            lengths.append((w1 >> (10 * i)) & 0x3FF)
        for i in range(max(0, nblocks - 3)):
            lengths.append((w2 >> (10 * i)) & 0x3FF)
        gaps = [((gbits >> (3 * i)) & 0x7) - 2 for i in range(nblocks)]
        return Align(pos1, pos2, gaps, lengths)
    pos1 = int(words[1])
    pos2 = int(words[2])
    nblocks = int(words[3])
    gaps = []
    lengths = []
    for i in range(nblocks):
        g = int(words[4 + 2 * i])
        if g >= 1 << 31:
            g -= 1 << 32
        gaps.append(g)
        lengths.append(int(words[5 + 2 * i]))
    return Align(pos1, pos2, gaps, lengths)
