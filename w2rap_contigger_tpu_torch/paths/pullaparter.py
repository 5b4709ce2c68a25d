"""PullAparter — duplicate canonical two-in/two-out repeat edges when
read pairs vote for a consistent phasing.

Reference: src/paths/long/large/PullAparter.h (the whole class is
header-inline).  A canonical repeat edge c sits between vleft
(1-out/2-in) and vright (1-in/2-out), giving four candidate traversals
l_i-c-r_j.  Read-pair support is scored per traversal by scanning each
pair's merged path (read + OverlapAppend of the partner's inverse path,
PullAparter.h:93-121); when the top two traversals are "parallel"
({0,3} or {1,2}), hold >= min_reads combined support, and dominate the
other two by >= min_mult, the repeat is pulled apart: a copy of c is
added between two new vertices, one (l, r) pair is rewired through it
(PullAparter.h:244-282), the mirror locus is edited identically, and
read paths are migrated to whichever copy their pair supports
(PullAparter.h:412-521); unsupported/conflicting pairs are removed.

Host-side surgery on numpy-list state, same pattern as graph/tamp.py.
"""

from __future__ import annotations

import numpy as np

from ..graph import ops
from ..graph.hbv import HyperBasevector
from .read_paths import ReadPathVec, invert_paths


def _overlap_append(v1: list, v2: list) -> list:
    """OverlapAppend (src/Vec.h:612): append v2 minus its longest
    prefix equal to a suffix of v1."""
    best = 0
    for o in range(min(len(v1), len(v2)), 0, -1):
        if v1[len(v1) - o :] == v2[:o]:
            best = o
            break
    return v1 + v2[best:]


class PullAparter:
    def __init__(self, hbv: HyperBasevector, paths: ReadPathVec,
                 min_reads: int = 5, min_mult: float = 5.0):
        self.hbv = hbv
        self.k = hbv.k
        self.min_reads = min_reads
        self.min_mult = min_mult
        self.removed_read_paths = 0

        E = hbv.n_edges
        self.seqs = [hbv.edge_seq(e) for e in range(E)]
        self.to_left = [int(v) for v in hbv.to_left]
        self.to_right = [int(v) for v in hbv.to_right]
        self.inv = [int(i) for i in hbv.inv]
        self.n_vertices = hbv.n_vertices
        self._out_deg = list(hbv.out_degree())
        self._in_deg = list(hbv.in_degree())
        fo, fe, to, te = hbv.vertex_csr()
        self._fo, self._fe, self._to, self._te = fo, fe, to, te

        self._orig_paths = paths
        self._pio, self._pir = invert_paths(paths, E)
        self._plist: dict[int, list] = {}
        self._starts = paths.start.astype(np.int64).copy()
        self._nuked = np.zeros(paths.n_reads, dtype=bool)
        self._index_override: dict[int, list] = {}

    # -- state accessors --------------------------------------------------
    def _path(self, r: int) -> list:
        if r not in self._plist:
            self._plist[r] = [int(e) for e in self._orig_paths.path(r)]
        return self._plist[r]

    def _edge_reads(self, e: int) -> list:
        if e in self._index_override:
            ids = self._index_override[e]
        else:
            ids = self._pir[self._pio[e] : self._pio[e + 1]]
        return [int(r) for r in ids if not self._nuked[r]]

    def _inverse_path(self, p: list) -> list:
        return [self.inv[e] for e in reversed(p)]

    def _nuke(self, read_ids):
        for r in read_ids:
            if self._nuked[r]:
                continue
            self._path(r).clear()
            self._nuked[r] = True
            self.removed_read_paths += 1

    # -- candidate detection ----------------------------------------------
    def is_canonical_repeat_edge(self, e: int) -> bool:
        """PullAparter.h:35-45."""
        vl, vr = self.to_left[e], self.to_right[e]
        if not (
            self._out_deg[vl] == 1
            and self._in_deg[vl] == 2
            and self._in_deg[vr] == 1
            and self._out_deg[vr] == 2
        ):
            return False
        ins = self._te[self._to[vl] : self._to[vl + 1]]
        return all(self.to_left[int(f)] != vr for f in ins)

    def _score_path_support_ends(self, cand_paths):
        """PullAparter.h:57-130: per candidate 3-edge path, count read
        pairs whose merged path traverses end->end in order (fw or rc).
        Returns (scores, support_read_ids per path)."""
        rpaths = [self._inverse_path(p) for p in cand_paths]
        ends = set()
        for p, rp in zip(cand_paths, rpaths):
            ends.update((p[0], p[2], rp[0], rp[2]))
        pair_ids = set()
        for e in sorted(ends):
            for r in self._edge_reads(e):
                pair_ids.add(r // 2)
        scores = [0] * len(cand_paths)
        score_reads = [[] for _ in cand_paths]
        for pid in sorted(pair_ids):
            r0, r1 = 2 * pid, 2 * pid + 1
            ext = _overlap_append(
                list(self._path(r0)), self._inverse_path(self._path(r1))
            )
            for ip, (p, rp) in enumerate(zip(cand_paths, rpaths)):
                f0 = f2 = r0_ = r2_ = -1
                for pos, e in enumerate(ext):
                    if e == p[0]:
                        f0 = pos
                    elif e == p[2]:
                        f2 = pos
                    elif e == rp[0]:
                        r0_ = pos
                    elif e == rp[2]:
                        r2_ = pos
                # unfound markers stay at end() in the reference, so the
                # f0 < f2 compare is only true when both were found
                fwd = f0 >= 0 and f2 >= 0 and f0 < f2
                rc = r0_ >= 0 and r2_ >= 0 and r0_ < r2_
                if fwd or rc:
                    scores[ip] += 1
                    score_reads[ip].extend((r0, r1))
        return scores, score_reads

    def is_separable(self, e: int, sep_paths: list, nuke: bool = True) -> bool:
        """PullAparter.h:159-237."""
        if not self.is_canonical_repeat_edge(e):
            return False
        vl, vr = self.to_left[e], self.to_right[e]
        led = [int(x) for x in self._te[self._to[vl] : self._to[vl + 1]]]
        red = [int(x) for x in self._fe[self._fo[vr] : self._fo[vr + 1]]]
        alledges = [e, led[0], led[1], red[0], red[1]]
        for x in alledges:
            if self.inv[x] in alledges:
                return False
        cand = [
            [led[0], e, red[0]],
            [led[0], e, red[1]],
            [led[1], e, red[0]],
            [led[1], e, red[1]],
        ]
        scores, score_reads = self._score_path_support_ends(cand)
        order = np.argsort(-np.asarray(scores), kind="stable")
        s = [scores[i] for i in order]
        sum1 = s[0] + s[1]
        if sum1 < self.min_reads or sum1 < self.min_mult * s[2] or sum1 < self.min_mult * s[3]:
            return False
        mask = (1 << int(order[0])) | (1 << int(order[1]))
        if mask == 0b1001:
            sep_paths.extend((cand[0], cand[3]))
            if nuke:
                self._nuke(score_reads[1])
                self._nuke(score_reads[2])
        elif mask == 0b0110:
            sep_paths.extend((cand[1], cand[2]))
            if nuke:
                self._nuke(score_reads[0])
                self._nuke(score_reads[3])
        else:
            return False
        return True

    # -- surgery ------------------------------------------------------------
    def _separate(self, path1: list, path2: list) -> int:
        """PullAparter.h:244-282: copy the center edge between two new
        vertices and rewire path1's side edges through it."""
        assert path1[1] == path2[1] and path1[0] != path2[0] and path1[2] != path2[2]
        center = path1[1]
        v1, v2 = self.to_left[center], self.to_right[center]
        nv1 = self.n_vertices
        nv2 = nv1 + 1
        self.n_vertices += 2
        new_center = len(self.seqs)
        self.seqs.append(self.seqs[center])
        self.to_left.append(nv1)
        self.to_right.append(nv2)
        self.to_right[path1[0]] = nv1
        self.to_left[path1[2]] = nv2
        return new_center

    def _migrate_read_paths(self, path1, path2, new_center):
        """PullAparter.h:412-521."""
        center = path1[1]
        new_inv, old_inv = [], []
        for r in self._edge_reads(center):
            p = self._path(r)
            if not p:
                continue
            partner = r + 1 if r % 2 == 0 else r - 1
            ext = _overlap_append(list(p), self._inverse_path(self._path(partner)))
            p1s = path1[0] in ext or path1[2] in ext
            p2s = path2[0] in ext or path2[2] in ext
            if p1s and not p2s:
                self._plist[r] = [new_center if e == center else e for e in p]
                new_inv.append(r)
            elif p2s and not p1s:
                old_inv.append(r)
            else:
                self._path(r).clear()
                self._nuked[r] = True
                self.removed_read_paths += 1
        self._index_override[center] = old_inv
        self._index_override[new_center] = new_inv

    def separate_all(self) -> int:
        """PullAparter.h:284-307 + 313-409; ends with the reference's
        RemoveUnneededVertices2 + dead-edge cleanup (via ops.squeeze)."""
        to_separate: list = []
        for e in range(len(self.inv)):
            if e < self.inv[e]:
                self.is_separable(e, to_separate, nuke=True)
        for i in range(0, len(to_separate), 2):
            p0, p1 = to_separate[i], to_separate[i + 1]
            inv0, inv1 = self._inverse_path(p0), self._inverse_path(p1)
            c_new = self._separate(p0, p1)
            c_new_inv = self._separate(inv0, inv1)
            self.inv.extend((c_new_inv, c_new))
            self._migrate_read_paths(p0, p1, c_new)
            self._migrate_read_paths(inv0, inv1, c_new_inv)
            p0[1] = c_new
        self._rebuild()
        return len(to_separate) // 2

    def _rebuild(self):
        flat, estart = HyperBasevector.from_edge_list(self.k, self.seqs)
        hbv2 = HyperBasevector(
            self.k,
            flat,
            estart,
            np.asarray(self.to_left, dtype=np.int32),
            np.asarray(self.to_right, dtype=np.int32),
            np.asarray(self.inv, dtype=np.int32),
            self.n_vertices,
        )
        paths = self._orig_paths
        n = paths.n_reads
        old_lens = paths.path_len()
        new_lens = old_lens.copy()
        for r, p in self._plist.items():
            new_lens[r] = len(p)
        off = np.zeros(n + 1, dtype=np.int64)
        off[1:] = np.cumsum(new_lens)
        flatp = np.zeros(int(off[-1]), dtype=np.int32)
        if len(paths.edges):
            rid = np.repeat(np.arange(n), old_lens)
            local = np.arange(len(paths.edges)) - np.repeat(
                paths.offsets[:-1], old_lens
            )
            unchanged = np.ones(n, dtype=bool)
            for r in self._plist:
                unchanged[r] = False
            m = unchanged[rid]
            flatp[(off[rid] + local)[m]] = paths.edges[m]
        for r, p in self._plist.items():
            flatp[off[r] : off[r] + len(p)] = p
        paths2 = ReadPathVec(off, flatp, self._starts.astype(np.int32))
        self.hbv, self.paths = ops.squeeze(hbv2, paths2)
