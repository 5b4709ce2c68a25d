"""PairsManager / ReadNameLookup equivalents.

* :class:`PairsManager` — read-pair + library bookkeeping with
  per-library separation/σ (reference ``src/PairsManager.h:25-294``,
  ``PM_Library`` at ``:71-110``). The TPU build keeps pairs implicit
  (read 2i ↔ 2i+1, the reference's innie convention) and this class
  carries the library metadata and pair→read queries on top, including
  separation estimation from an observed separation sample (the
  reference estimates per-lib sep/sd from alignments).
* :class:`ReadNameLookup` — read-name → id index (reference
  ``src/paths/long/large/ReadNameLookup.{h,cc}``), used to pair BAM
  records and to map name-addressed inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PMLibrary:
    """PM_Library (PairsManager.h:71-110)."""

    name: str
    sep: int = 0
    sd: int = 0


class PairsManager:
    """Interleaved-pair manager: pair p = reads (2p, 2p+1)."""

    def __init__(self, n_reads: int):
        assert n_reads % 2 == 0
        self._n_reads = n_reads
        self._libs: list[PMLibrary] = []
        self._lib_ids = np.zeros(n_reads // 2, dtype=np.int32)

    @property
    def n_pairs(self) -> int:
        return self._n_reads // 2

    @property
    def n_reads(self) -> int:
        return self._n_reads

    def add_library(self, sep: int, sd: int, name: str = "",
                    pair_range=None) -> int:
        """addLibrary (PairsManager.h:252); pair_range optionally
        assigns a contiguous pair span to the new library."""
        lib_id = len(self._libs)
        self._libs.append(PMLibrary(name or f"lib{lib_id}", sep, sd))
        if pair_range is not None:
            a, b = pair_range
            self._lib_ids[a:b] = lib_id
        return lib_id

    def lib_of_pair(self, pair_id: int) -> int:
        return int(self._lib_ids[pair_id])

    def sep(self, pair_id: int) -> int:
        return self._libs[self.lib_of_pair(pair_id)].sep

    def sd(self, pair_id: int) -> int:
        return self._libs[self.lib_of_pair(pair_id)].sd

    def change_library_sep_sd(self, lib_id: int, sep: int, sd: int) -> None:
        self._libs[lib_id].sep = sep
        self._libs[lib_id].sd = sd

    def id1(self, pair_id: int) -> int:
        return 2 * pair_id

    def id2(self, pair_id: int) -> int:
        return 2 * pair_id + 1

    def pair_id(self, read_id: int) -> int:
        return read_id // 2

    def partner(self, read_id: int) -> int:
        return read_id ^ 1

    def estimate_library_stats(self, seps, lib_id: int = 0) -> None:
        """Set a library's sep/sd from an observed separation sample
        (the reference recomputes these from read placements,
        PairsManager.h:192)."""
        seps = np.asarray(seps, dtype=np.int64)
        self.change_library_sep_sd(
            lib_id, int(round(seps.mean())), int(round(seps.std())))

    @property
    def libraries(self):
        return list(self._libs)


class ReadNameLookup:
    """readname_lookup (ReadNameLookup.h): name -> read id; names with
    .1/.2 pair suffixes resolve through the base name."""

    def __init__(self):
        self._idx: dict[str, int] = {}

    @classmethod
    def from_names(cls, names) -> "ReadNameLookup":
        rl = cls()
        for i, n in enumerate(names):
            rl.add(n, i)
        return rl

    def add(self, name: str, read_id: int) -> None:
        if name in self._idx:
            raise ValueError(f"duplicate read name {name!r}")
        self._idx[name] = read_id

    def get(self, name: str) -> int:
        if name in self._idx:
            return self._idx[name]
        # pair-suffix resolution: base.1/base.2 -> consecutive ids
        if name[-2:] in (".1", ".2") and name[:-2] in self._idx:
            base = self._idx[name[:-2]]
            return base if name.endswith(".1") else base + 1
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def __len__(self) -> int:
        return len(self._idx)
