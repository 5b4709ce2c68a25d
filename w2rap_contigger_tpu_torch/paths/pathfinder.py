"""PathFinder — w2rap's original repeat untangler.

Reference: src/paths/PathFinder.{h,cc} (920 LoC).  Operates on
(HBV, inv, paths, paths_index):

* path_votes / multi_path_votes (PathFinder.cc:44-330): walk candidate
  edge paths against the read paths, collecting FOR / PARTIAL / AGAINST
  votes (deduped per read),
* unroll_loops(min_side=800) (:369): canonical loop motif
  prev->repeat->loop->repeat->next resolved by votes + coverage,
* untangle_complex_in_out_choices(700) (:468): complex regions between
  long frontier edges solved when read paths give a perfect one-to-one
  in/out pairing,
* separate_path (:798): graph surgery duplicating the repeat interior
  for the resolved traversal (+ rc mirror),
* migrate_readpaths (:865): path translation onto the duplicated edges,
* classify_forks (:335): fork statistics log.

Deliberate deviations: the reference reads pv[3] out of bounds on a
3-element vote array (is_unrollable_loop, PathFinder.cc:760) — we treat
that garbage read as 0; ambiguous path migrations pick the first valid
combination instead of rand().
"""

from __future__ import annotations

import numpy as np

from .read_paths import ReadPathVec, invert_paths


class PathFinder:
    def __init__(self, hbv, paths: ReadPathVec):
        self.hbv = hbv
        self.paths = paths
        self._reindex()

    # ------------------------------------------------------------------
    def _reindex(self):
        hbv = self.hbv
        self.inv = hbv.inv
        fo, fe, to, te = hbv.vertex_csr()
        self.next_edges = [
            [int(x) for x in fe[fo[hbv.to_right[e]] : fo[hbv.to_right[e] + 1]]]
            for e in range(hbv.n_edges)
        ]
        self.prev_edges = [
            [int(x) for x in te[to[hbv.to_left[e]] : to[hbv.to_left[e] + 1]]]
            for e in range(hbv.n_edges)
        ]
        off, rid = invert_paths(self.paths, hbv.n_edges)
        self.edge_to_pids = [
            sorted(set(int(x) for x in rid[off[e] : off[e + 1]]))
            for e in range(hbv.n_edges)
        ]

    # ------------------------------------------------------------------
    def path_votes(self, path):
        return self.multi_path_votes([path])

    def multi_path_votes(self, cand_paths):
        """{FOR, PARTIAL, AGAINST} votes over candidate paths, deduped
        per read (PathFinder.cc:44-190)."""
        vfor, vpartial, vagainst = [], [], []
        for path in cand_paths:
            initial, open_ = [], []
            for pid in self.edge_to_pids[path[0]]:
                p = [int(x) for x in self.paths.path(pid)]
                if len(p) > 1 and path[0] in p:
                    i = p.index(path[0])
                    if i < len(p) - 1:
                        open_.append([pid, p, i])
            initial = [o[0] for o in open_]
            for ei in range(1, len(path)):
                e = path[ei]
                keep = []
                for o in open_:
                    pid, p, i = o
                    if p[i + 1] != e:
                        vagainst.append(pid)
                    else:
                        keep.append([pid, p, i + 1])
                open_ = keep
                new_paths = []
                open_pids = {o[0] for o in open_}
                for pid in self.edge_to_pids[e]:
                    p = [int(x) for x in self.paths.path(pid)]
                    if len(p) == 1:
                        continue
                    if p[0] == e:
                        new_paths.append([pid, p, 0])
                        continue
                    if pid in open_pids:
                        o = next(o for o in open_ if o[0] == pid)
                        if ei == len(path) - 1:
                            (vfor if pid in initial else vpartial).append(pid)
                        elif len(o[1]) - 1 == o[2]:
                            vpartial.append(pid)
                            open_ = [x for x in open_ if x[0] != pid]
                    else:
                        vagainst.append(pid)
                open_.extend(new_paths)
        used = set()
        pv = [0, 0, 0]
        for i, lst in enumerate((vfor, vpartial, vagainst)):
            for pid in lst:
                if pid not in used:
                    used.add(pid)
                    pv[i] += 1
        return pv

    def paths_per_kbp(self, e):
        return 1000 * len(self.edge_to_pids[e]) // max(1, self.hbv.edge_len(e))

    # ------------------------------------------------------------------
    def is_unrollable_loop(self, loop_e, min_side):
        """PathFinder.cc:726-795."""
        inv = self.inv
        if (
            len(self.prev_edges[loop_e]) != 1
            or len(self.next_edges[loop_e]) != 1
            or self.prev_edges[loop_e][0] != self.next_edges[loop_e][0]
        ):
            return []
        repeat_e = self.prev_edges[loop_e][0]
        if len(self.prev_edges[repeat_e]) != 2 or len(self.next_edges[repeat_e]) != 2:
            return []
        pe = self.prev_edges[repeat_e]
        ne = self.next_edges[repeat_e]
        prev_e = pe[1] if pe[0] == loop_e else pe[0]
        next_e = ne[1] if ne[0] == loop_e else ne[0]
        if prev_e == next_e or prev_e == int(inv[next_e]):
            return []
        if self.hbv.edge_len(prev_e) < min_side or self.hbv.edge_len(next_e) < min_side:
            return []
        pvlin = self.path_votes([prev_e, repeat_e, loop_e, repeat_e, next_e])
        pvloop = self.path_votes(
            [prev_e, repeat_e, loop_e, repeat_e, loop_e, repeat_e, next_e]
        )
        pvcl = self.multi_path_votes(
            [[loop_e, repeat_e, loop_e], [prev_e, repeat_e, next_e]]
        )
        if pvcl[0] > 0 or pvloop[2] > 0 or (
            pvcl[2] == 0 and pvcl[1] > pvlin[1] and pvcl[1] > pvloop[1]
        ):
            return []
        # reference reads pv[3] OOB here; treated as 0 (always-true guard)
        if pvloop[0] > pvlin[0]:
            return []
        if pvlin == pvcl:
            prev_cov = self.paths_per_kbp(prev_e)
            repeat_cov = self.paths_per_kbp(repeat_e)
            loop_cov = self.paths_per_kbp(loop_e)
            next_cov = self.paths_per_kbp(next_e)
            sc_min, sc_max = prev_cov * 0.8, prev_cov * 1.2
            dc_min, dc_max = prev_cov * 1.8, prev_cov * 2.2
            if (
                repeat_cov < dc_min
                or repeat_cov > dc_max
                or loop_cov < sc_min
                or loop_cov > sc_max
                or next_cov < sc_min
                or next_cov > sc_max
            ):
                return []
        return [[prev_e, repeat_e, loop_e, repeat_e, next_e]]

    def unroll_loops(self, min_side=800):
        """PathFinder.cc:369-412."""
        new_paths = []
        for e in range(self.hbv.n_edges):
            if e < int(self.inv[e]):
                urs = self.is_unrollable_loop(e, min_side)
                iurs = self.is_unrollable_loop(int(self.inv[e]), min_side)
                if urs and iurs:
                    new_paths.append(urs[0])
        edgemap = {}
        for p in new_paths:
            oen = self.separate_path(p)
            for k, v in oen.items():
                edgemap.setdefault(k, []).extend(v)
        if edgemap:
            self.migrate_readpaths(edgemap)
        self._reindex()
        return len(new_paths)

    # ------------------------------------------------------------------
    def get_all_long_frontiers(self, e, large_frontier_size):
        """PathFinder.cc:638-725."""
        inv = self.inv
        elen = self.hbv.edge_len()
        seen, to_explore = set(), {e}
        in_f, out_f = set(), set()
        while to_explore:
            nxt_explore = set()
            for x in to_explore:
                if x not in seen:
                    if int(inv[x]) in seen:
                        return None
                    for p in self.prev_edges[x]:
                        if elen[p] >= large_frontier_size:
                            in_f.add(p)
                            for on in self.next_edges[p]:
                                if on not in seen:
                                    if elen[on] >= large_frontier_size:
                                        out_f.add(on)
                                        seen.add(on)
                                    else:
                                        nxt_explore.add(on)
                        elif p not in seen:
                            nxt_explore.add(p)
                    for n in self.next_edges[x]:
                        if elen[n] >= large_frontier_size:
                            out_f.add(n)
                            for op in self.prev_edges[n]:
                                if op not in seen:
                                    if elen[op] >= large_frontier_size:
                                        in_f.add(op)
                                        seen.add(op)
                                    else:
                                        nxt_explore.add(op)
                        elif n not in seen:
                            nxt_explore.add(n)
                    seen.add(x)
                if len(seen) > 50:
                    return None
            to_explore = nxt_explore
        if in_f and out_f:
            min_in = min(min(i, int(inv[i])) for i in in_f)
            min_out = min(min(i, int(inv[i])) for i in out_f)
            if min_out < min_in:
                in_f, out_f = (
                    {int(inv[x]) for x in out_f},
                    {int(inv[x]) for x in in_f},
                )
        return (sorted(in_f), sorted(out_f))

    def untangle_complex_in_out_choices(self, large_frontier_size=700):
        """PathFinder.cc:468-616."""
        inv = self.inv
        elen = self.hbv.edge_len()
        seen_frontiers, paths_to_separate = set(), []
        for e in range(self.hbv.n_edges):
            if e < int(inv[e]) and elen[e] < large_frontier_size:
                f = self.get_all_long_frontiers(e, large_frontier_size)
                if not f or len(f[0]) <= 1 or len(f[1]) <= 1:
                    continue
                key = (tuple(f[0]), tuple(f[1]))
                if key in seen_frontiers:
                    continue
                seen_frontiers.add(key)
                if set(f[0]) & set(f[1]):
                    continue
                in_used = [0] * len(f[0])
                out_used = [0] * len(f[1])
                ffp = []
                reversed_ = False
                for ii, in_e in enumerate(f[0]):
                    for oi, out_e in enumerate(f[1]):
                        shared = 0
                        for pid in self.edge_to_pids[in_e]:
                            if pid in self.edge_to_pids[out_e]:
                                shared += 1
                                if shared == 1:
                                    p = [int(x) for x in self.paths.path(pid)]
                                    fp, rev = _clip_path(p, in_e, out_e)
                                    reversed_ |= rev
                                    ffp.append(fp)
                        for pid in self.edge_to_pids[int(inv[out_e])]:
                            if pid in self.edge_to_pids[int(inv[in_e])]:
                                shared += 1
                                if shared == 1:
                                    p = [
                                        int(inv[x])
                                        for x in self.paths.path(pid)[::-1]
                                    ]
                                    fp, rev = _clip_path(p, in_e, out_e)
                                    reversed_ |= rev
                                    ffp.append(fp)
                        if shared:
                            in_used[ii] += 1
                            out_used[oi] += 1
                if (
                    not reversed_
                    and all(u == 1 for u in in_used)
                    and all(u == 1 for u in out_used)
                ):
                    paths_to_separate.extend(ffp)

        edgemap = {}
        sep = 0
        for p in paths_to_separate:
            if p[0] in edgemap or p[-1] in edgemap:
                continue
            oen = self.separate_path(p)
            for k, v in oen.items():
                edgemap.setdefault(k, []).extend(v)
            if oen:
                sep += 1
        if edgemap:
            self.migrate_readpaths(edgemap)
        self._reindex()
        return sep

    # ------------------------------------------------------------------
    def separate_path(self, p):
        """PathFinder.cc:798-862: duplicate the repeat interior of p (and
        its rc mirror) onto fresh vertices."""
        hbv = self.hbv
        inv = self.inv
        fw, rev = set(), set()
        for e in p:
            fw.add(e)
            rev.add(int(inv[e]))
            if int(inv[e]) in fw or e in rev:
                return {}
        # new vertices
        cur_fw = hbv.n_vertices
        cur_rev = hbv.n_vertices + 1
        hbv.n_vertices += 2
        to_left = hbv.to_left
        to_right = hbv.to_right
        to_right[p[0]] = cur_fw
        to_left[int(inv[p[0]])] = cur_rev
        old_to_new = {}
        new_edges = []  # (seq_src_edge, vleft, vright, inv_partner_rel)
        for ei in range(1, len(p) - 1):
            prev_fw, prev_rev = cur_fw, cur_rev
            cur_fw = hbv.n_vertices
            cur_rev = hbv.n_vertices + 1
            hbv.n_vertices += 2
            nef = hbv.n_edges + len(new_edges)
            new_edges.append((p[ei], prev_fw, cur_fw))
            old_to_new.setdefault(p[ei], []).append(nef)
            ner = hbv.n_edges + len(new_edges)
            new_edges.append((int(inv[p[ei]]), cur_rev, prev_rev))
            old_to_new.setdefault(int(inv[p[ei]]), []).append(ner)
        to_left[p[-1]] = cur_fw
        to_right[int(inv[p[-1]])] = cur_rev

        if new_edges:
            self._append_edges(new_edges)
        return old_to_new

    def _append_edges(self, new_edges):
        """Append duplicated edges (seq copied from src edge) + inv."""
        hbv = self.hbv
        E0 = hbv.n_edges
        seqs = [hbv.edge_seq(src).copy() for src, _, _ in new_edges]
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        add_start = np.zeros(len(seqs), dtype=np.int64)
        add_start[:] = np.cumsum(lens) - lens
        flat = (
            np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
        )
        hbv.edge_bases = np.concatenate([hbv.edge_bases, flat])
        base0 = hbv.edge_start[-1]
        hbv.edge_start = np.concatenate(
            [hbv.edge_start, base0 + np.cumsum(lens)]
        )
        hbv.to_left = np.concatenate(
            [hbv.to_left, np.array([v for _, v, _ in new_edges], np.int32)]
        )
        hbv.to_right = np.concatenate(
            [hbv.to_right, np.array([w for _, _, w in new_edges], np.int32)]
        )
        # pairs are appended adjacently: (fw, rc), so inv is the swap
        inv_new = np.arange(E0, E0 + len(new_edges), dtype=np.int32)
        inv_new += np.where(inv_new % 2 == E0 % 2, 1, -1)
        hbv.inv = np.concatenate([hbv.inv, inv_new])

    def migrate_readpaths(self, edgemap):
        """PathFinder.cc:865-917 (deterministic: first valid combination)."""
        hbv = self.hbv
        paths = self.paths
        out_paths = []
        for i in range(paths.n_reads):
            p = [int(x) for x in paths.path(i)]
            if not any(e in edgemap for e in p):
                out_paths.append(p)
                continue
            options = [edgemap.get(e, [e]) for e in p]
            if all(len(o) == 1 for o in options):
                out_paths.append([o[0] for o in options])
                continue
            combos = [[]]
            for oi, opts in enumerate(options):
                nxt = []
                for c in combos:
                    for e in opts:
                        if oi == 0 or hbv.to_right[c[-1]] == hbv.to_left[e]:
                            nxt.append(c + [e])
                combos = nxt
                if not combos:
                    break
            if combos:
                out_paths.append(combos[0])
            else:
                out_paths.append(p[:1])
        self.paths = ReadPathVec.from_lists(out_paths, paths.start)

    # ------------------------------------------------------------------
    def classify_forks(self, log=False):
        """PathFinder.cc:335-367 fork statistics (counts + base sizes);
        vectorized over the right-vertex degrees of every edge."""
        hbv = self.hbv
        outdeg = np.asarray(hbv.out_degree())
        indeg = np.asarray(hbv.in_degree())
        elen = np.asarray(hbv.edge_len())
        v = np.asarray(hbv.to_right)[: hbv.n_edges]
        od, idg = outdeg[v], indeg[v]
        cls = np.where(
            od == 0, 0,
            np.where(od == 1, np.where(idg == 1, 1, 3),
                     np.where(idg == 1, 2, 4)),
        )
        names = ("nothing", "line", "join", "split", "join_split")
        stats = {}
        for c, name in enumerate(names):
            m = cls == c
            stats[name] = int(m.sum())
            stats[name + "_size"] = int(elen[: hbv.n_edges][m].sum())
        if log:
            print("Forward Node Edge Classification: ")
            for name in names:
                print(f"{name}_fw: {stats[name]} "
                      f"( {stats[name + '_size']} kmers )")
        return stats


def _clip_path(p, in_e, out_e):
    """Clip p to the segment [in_e .. out_e]; returns (segment, reversed)."""
    out = []
    try:
        ei = p.index(in_e)
    except ValueError:
        return [in_e, out_e], True
    while ei < len(p) and p[ei] != out_e:
        out.append(p[ei])
        ei += 1
    rev = ei >= len(p)
    out.append(out_e)
    return out, rev
