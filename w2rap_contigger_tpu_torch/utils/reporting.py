"""Reporting utilities: PerfStat logger, TextTable, dedup Logger,
IntDistribution.

Reference parity targets:
* ``PerfStatLogger::log(key, value, gloss)`` key-value metric lines for
  external regression tooling (``src/reporting/PerfStat.h:24-60``).
* ``TextTable`` column-aligned text tables (``src/util/TextTable.h``).
* ``util/Logger`` — error log that deduplicates repeated messages and
  prints each with an occurrence count (``src/util/Logger.h:14-31``).
* ``IntDistribution`` — distribution over a signed-integer support with
  cdf/quantile queries, used for read-pair separation distributions
  (``src/math/IntDistribution.h:21-160``).
"""

from __future__ import annotations

import sys

import numpy as np


class PerfStatLogger:
    """PerfStat.h:50 — `log(key, value, gloss)`; emitted in a stable
    machine-greppable format."""

    def __init__(self, stream=None):
        self._rows = []
        self._stream = stream

    def log(self, key: str, value, gloss: str = "") -> None:
        self._rows.append((key, value, gloss))
        stream = self._stream if self._stream is not None else sys.stdout
        print(f"PERFSTAT: {key} = {value} [{gloss}]", file=stream)

    @property
    def rows(self):
        return list(self._rows)


class TextTable:
    """Minimal TextTable: add rows, render column-aligned lines."""

    def __init__(self):
        self._rows: list[list[str]] = []

    def add_row(self, *cells) -> None:
        self._rows.append([str(c) for c in cells])

    def render(self, sep: str = "  ") -> str:
        if not self._rows:
            return ""
        ncol = max(len(r) for r in self._rows)
        widths = [0] * ncol
        for r in self._rows:
            for i, c in enumerate(r):
                widths[i] = max(widths[i], len(c))
        lines = [sep.join(c.ljust(widths[i]) for i, c in enumerate(r)).rstrip()
                 for r in self._rows]
        return "\n".join(lines)


class Logger:
    """Dedup message log (util/Logger.h:14-31): identical messages are
    counted, not repeated."""

    def __init__(self, name: str = "log"):
        self.name = name
        self._counts: dict[str, int] = {}
        self._order: list[str] = []

    def log(self, msg: str) -> None:
        if msg not in self._counts:
            self._counts[msg] = 0
            self._order.append(msg)
        self._counts[msg] += 1

    def dump(self, stream=None) -> None:
        stream = stream if stream is not None else sys.stdout
        for msg in self._order:
            print(f"[{self.name}] ({self._counts[msg]}x) {msg}", file=stream)

    def count(self, msg: str) -> int:
        return self._counts.get(msg, 0)


class IntDistribution:
    """Probability distribution over [x_min, x_max] ⊂ ℤ
    (math/IntDistribution.h:21): normalized pmf + prefix sums for O(1)
    cdf; quantiles by binary search."""

    def __init__(self, x_min: int, weights):
        w = np.asarray(weights, dtype=np.float64)
        assert (w >= 0).all() and w.sum() > 0
        self.x_min = int(x_min)
        self.prob = w / w.sum()
        self._cdf = np.cumsum(self.prob)

    @property
    def x_max(self) -> int:
        return self.x_min + len(self.prob) - 1

    @classmethod
    def from_samples(cls, samples) -> "IntDistribution":
        samples = np.asarray(samples, dtype=np.int64)
        lo, hi = int(samples.min()), int(samples.max())
        w = np.bincount(samples - lo, minlength=hi - lo + 1)
        return cls(lo, w)

    def prob_at(self, x: int) -> float:
        i = x - self.x_min
        if i < 0 or i >= len(self.prob):
            return 0.0
        return float(self.prob[i])

    def prob_le(self, x: int) -> float:
        i = x - self.x_min
        if i < 0:
            return 0.0
        if i >= len(self._cdf):
            return 1.0
        return float(self._cdf[i])

    def prob_in(self, a: int, b: int) -> float:
        """P(a <= X <= b)."""
        return self.prob_le(b) - self.prob_le(a - 1)

    def mean(self) -> float:
        xs = np.arange(len(self.prob)) + self.x_min
        return float((xs * self.prob).sum())

    def sd(self) -> float:
        xs = np.arange(len(self.prob)) + self.x_min
        mu = self.mean()
        return float(np.sqrt(((xs - mu) ** 2 * self.prob).sum()))

    def quantile(self, q: float) -> int:
        i = int(np.searchsorted(self._cdf, q, side="left"))
        return self.x_min + min(i, len(self.prob) - 1)

    def median(self) -> int:
        return self.quantile(0.5)
