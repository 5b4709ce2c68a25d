"""Coverage peak detection: PeakFinder + CN1PeakFinder.

Parity with the reference's copy-number calling support
(``src/util/PeakFinder.h:15-134`` and
``src/paths/long/large/CN1PeakFinder.{h,cc}``): sliding-window peak
candidates over a kmer/coverage histogram, trough-depth filtering, then
a CN-multiple matching score to pick the CN=1 coverage peak (used for
``cn_frac_good`` / line copy numbers). Host-side: the histograms are
tiny by the time they reach here (the heavy per-base coverage reduction
runs on device in pipeline/coverage.py).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np


@dataclasses.dataclass
class PeakFinder:
    """PeakFinder<X,Y> (PeakFinder.h:15-134)."""

    window: float = 0.05
    min_shoulder: int = 10
    min_peak_ratio: int = 10000
    min_peak_height_ratio: float = 1.2

    def find_peaks_y(self, y) -> list[int]:
        """Shoulder-window candidates (PeakFinder.h:27-45): index i is a
        candidate iff it is the first maximum of
        y[i-min_shoulder : i+min_shoulder+1] and clears the global
        noise floor."""
        y = np.asarray(y)
        n = len(y)
        out = []
        if n <= 2 * self.min_shoulder:
            return out
        gmax = y.max()
        s = self.min_shoulder
        for i in range(s, n - s):
            win = y[i - s:i + s + 1]
            if int(np.argmax(win)) == s and y[i] >= gmax / self.min_peak_ratio:
                out.append(i)
        return out

    def find_peaks(self, x, y) -> list[int]:
        """Windowed refinement over sorted x (PeakFinder.h:47-131):
        keep candidates that are the maximum within the fractional
        x-window, have dense shoulders, deep troughs; then centralize
        across equal-valued plateaus."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y)
        assert len(x) == len(y)
        if len(x) == 0:
            return []
        candidates = []
        for i in self.find_peaks_y(y):
            cx = x[i]
            li = bisect.bisect_right(x, cx * (1.0 - self.window))
            ri = bisect.bisect_right(x, cx * (1.0 + self.window))
            if li == 0 or ri == len(x):
                continue  # edge of data
            if i - li < self.min_shoulder or ri - i - 1 < self.min_shoulder:
                continue  # sparse data
            if int(np.argmax(y[li:ri])) + li == i:
                candidates.append(i)
        # trough-depth filter
        keep = []
        for idx, i in enumerate(candidates):
            left_peak = candidates[idx - 1] if idx else 0
            right_peak = (candidates[idx + 1] if idx + 1 < len(candidates)
                          else len(x))
            left_min = y[left_peak:i].min() if i > left_peak else y[i]
            right_min = y[i:right_peak].min()
            if max(left_min, right_min) * self.min_peak_height_ratio <= y[i]:
                keep.append(i)
        # centralize across plateaus
        out = []
        for i in keep:
            end = i + 1
            while end < len(y) and y[end] == y[i]:
                end += 1
            out.append(i + (end - i - 1) // 2)
        return out


@dataclasses.dataclass
class CN1PeakFinder:
    """CN1 coverage-peak caller (CN1PeakFinder.cc:40-131)."""

    high_cn_prefilter: int = 5
    max_peak_tolerance: float = 0.1

    def __post_init__(self):
        self.candidates: list[int] = []
        self.cn_peaks: list[int] = []
        self.cn_values: list[int] = []
        self.cn1_coverage: float = 0.0
        self.diploid: bool = False

    def _max_peak(self, mass) -> int:
        best = 0
        for i in range(len(self.candidates)):
            if mass[self.candidates[i]] > mass[self.candidates[best]]:
                best = i
        return best

    def _match_peak(self, coverage, used, base, multiplier) -> bool:
        target = base * multiplier
        for i in range(len(used)):
            if used[i] == 0 and abs(
                    target - coverage[self.candidates[i]]
            ) < self.max_peak_tolerance * target:
                used[i] = int(multiplier if multiplier >= 1
                              else -1.0 / multiplier)
                return True
        return False

    def _prefilter(self, coverage, mass) -> None:
        if len(self.candidates) < 2:
            return
        max_cov = coverage[self.candidates[self._max_peak(mass)]]
        n = 0
        while n < len(self.candidates) and (
                coverage[self.candidates[n]]
                <= self.high_cn_prefilter * max_cov):
            n += 1
        del self.candidates[n:]

    def find_peak(self, coverage, mass) -> float:
        """Returns the CN=1 coverage (CN1PeakFinder.cc:40-131)."""
        coverage = np.asarray(coverage, dtype=np.float64)
        mass = np.asarray(mass, dtype=np.int64)
        if len(mass) == 0:
            return 0.0
        self.candidates = PeakFinder().find_peaks(coverage, mass)
        self._prefilter(coverage, mass)
        pc = len(self.candidates)
        if pc == 1:
            self.cn_peaks = [self.candidates[0]]
            self.cn_values = [1]
        elif pc == 0:
            self.cn_peaks = [int(np.argmax(mass))]
            self.cn_values = [1]
        else:
            max_peak = self._max_peak(mass)
            best_score, best_used = 0, []
            for i in range(pc):
                base_cov = coverage[self.candidates[i]]
                used = [0] * pc
                used[i] = 1
                if i > 0:
                    self._match_peak(coverage, used, base_cov, 0.5)
                for mult in range(2, self.high_cn_prefilter + 1):
                    self._match_peak(coverage, used, base_cov, mult)
                score = sum(1 for v in used if v != 0)
                if used[max_peak] != 0:
                    if score == best_score:
                        # prefer diploid if the haploid peak is 10x smaller
                        dips = [j for j, v in enumerate(used) if v == -2]
                        if dips and mass[self.candidates[dips[0]]] * 10 < \
                                mass[self.candidates[i]]:
                            best_score, best_used = score, used
                    elif score > best_score:
                        best_score, best_used = score, used
            for i, v in enumerate(best_used):
                if v != 0:
                    self.cn_peaks.append(self.candidates[i])
                    self.cn_values.append(v)
        if len(self.cn_peaks) > 1 and \
                mass[self.cn_peaks[0]] < mass[self.cn_peaks[1]]:
            self.cn1_coverage = coverage[self.cn_peaks[1]] / 2.0
        else:
            self.cn1_coverage = coverage[self.cn_peaks[0]]
        self.diploid = bool(self.cn_values and self.cn_values[0] == -2)
        return float(self.cn1_coverage)
