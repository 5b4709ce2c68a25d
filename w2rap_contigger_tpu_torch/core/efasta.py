"""efasta — FASTA with `{ALT1,ALT2,...}` ambiguity alternatives.

Parity with the reference's corrected-read representation
(``src/efasta/EfastaTools.h:15-139``): an efasta record is a DNA string
in which brace groups list alternative sub-sequences (possibly of
different lengths, possibly empty). The local-assembly engine expands
corrected reads' ambiguities into concrete base vectors before graph
building (``ExpandTo`` used at ``src/paths/long/LongHyper.cc:63``).
"""

from __future__ import annotations

import itertools

import numpy as np

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def parse(s: str):
    """Split an efasta string into segments: plain str or tuple of
    alternative strs (brace groups)."""
    segs = []
    i, n = 0, len(s)
    while i < n:
        if s[i] == "{":
            j = s.index("}", i)
            segs.append(tuple(s[i + 1:j].split(",")))
            i = j + 1
        else:
            j = i
            while j < n and s[j] != "{":
                j += 1
            segs.append(s[i:j])
            i = j
    return segs


def amb_count(s: str):
    """(amb_bases, snp_count, indel_count) — EfastaTools.h:100-105: the
    number of ambiguous bases is the max alternative length per group."""
    amb = snps = indels = 0
    for seg in parse(s):
        if isinstance(seg, tuple):
            lens = {len(a) for a in seg}
            amb += max(lens)
            if len(lens) == 1:
                snps += 1
            else:
                indels += 1
    return amb, snps, indels


def expand_to(s: str, max_count: int = -1):
    """All concrete expansions, in lexicographic group order
    (EfastaTools.h:129-134). Returns None when the expansion count
    would exceed max_count (the reference returns False)."""
    segs = parse(s)
    choices = [sorted(seg) if isinstance(seg, tuple) else [seg]
               for seg in segs]
    count = 1
    for c in choices:
        count *= len(c)
        if max_count >= 0 and count > max_count:
            return None
    return ["".join(p) for p in itertools.product(*choices)]


def flatten_to(s: str) -> str:
    """First (sorted) alternative of each group — the reference's
    FlattenTo picks the first alternative (EfastaTools.h:118)."""
    return "".join(seg if isinstance(seg, str) else sorted(seg)[0]
                   for seg in parse(s))


def to_codes(seq: str) -> np.ndarray:
    return np.asarray([_CODE[c] for c in seq], dtype=np.uint8)


def expand_to_codes(s: str, max_count: int = -1):
    out = expand_to(s, max_count)
    if out is None:
        return None
    return [to_codes(x) for x in out]
