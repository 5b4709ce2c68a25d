"""Lines — bubble-chain decomposition and final contig emission.

Faithful reimplementation of the reference line machinery:
* FindSomeCells (src/graph/FindCells.cc:195-298)
* FindLines (src/paths/long/large/Lines.cc:23-320): cells -> symmetrize
  -> EdgePaths per cell -> subset-cell removal -> gap cells -> greedy
  left/right chain join from the longest edges -> rc mirror lines ->
  identical/subset line removal
* GetLineLengths (Lines.h:80-128): per-cell median path length in kmers
* DumpLineFiles (Lines.cc:680-800): one fasta record per line pair,
  most-likely bubble path by read votes, 100-N gap cells
* line N50 + stats (FinalFiles.cc:75-105)

Line data model (Lines.h:16-46): line = list of cells, even cells are
single straight edges, odd cells are path sets (bubbles; empty = gap).
"""

from __future__ import annotations

import numpy as np

from ..core.dna import codes_to_seq, n50


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _adj(hbv):
    fo, fe, to, te = hbv.vertex_csr()

    def outs(v):
        return fe[fo[v] : fo[v + 1]]

    def ins(v):
        return te[to[v] : to[v + 1]]

    return outs, ins


def find_some_cells(hbv, max_cell_size: int, max_depth: int):
    """FindSomeCells (FindCells.cc:195): candidate (v, w) cell bounds."""
    outs, ins = _adj(hbv)
    to_left, to_right = hbv.to_left, hbv.to_right
    bounds = []
    for v in range(hbv.n_vertices):
        ov = outs(v)
        if len(ins(v)) != 1 or len(ov) <= 1:
            continue
        if v in set(int(to_right[e]) for e in ov):
            continue
        # downstream vertex sets per branch (depth-limited BFS)
        no = len(ov)
        down = []
        for j in range(no):
            start_v = int(to_right[ov[j]])
            lst = [start_v]
            dep = [0]
            pos = {start_v: 0}  # O(1) membership (was list.index)
            i = 0
            while i < len(lst):
                if dep[i] == max_depth:
                    i += 1
                    continue
                for e2 in outs(lst[i]):
                    w2 = int(to_right[e2])
                    p = pos.get(w2)
                    if p is not None:
                        if dep[p] > dep[i] + 1:
                            dep[p] = dep[i] + 1
                    else:
                        pos[w2] = len(lst)
                        lst.append(w2)
                        dep.append(dep[i] + 1)
                i += 1
            down.append(set(lst))
        ex = set.intersection(*down) if down else set()
        ex = [
            w
            for w in sorted(ex)
            if len(outs(w)) == 1
            and len(ins(w)) > 1
            and w not in set(int(to_left[e]) for e in ins(w))
        ]
        xs, ex2 = [], []
        for w in ex:
            x = [v]
            xset = {v}
            bad = False
            j = 0
            while j < len(x):
                if len(x) > max_cell_size or len(outs(x[j])) == 0 or len(ins(x[j])) == 0:
                    bad = True
                    break
                if x[j] != w:
                    for e2 in outs(x[j]):
                        t = int(to_right[e2])
                        if t == v:
                            bad = True
                            break
                        if t not in xset:
                            x.append(t)
                            xset.add(t)
                    if bad:
                        break
                if x[j] != v:
                    for e2 in ins(x[j]):
                        t = int(to_left[e2])
                        if t == w:
                            bad = True
                            break
                        if t not in xset:
                            x.append(t)
                            xset.add(t)
                    if bad:
                        break
                j += 1
            if bad or len(x) > max_cell_size:
                continue
            # cycle check within the cell (excluding w)
            for xj in x:
                if bad:
                    break
                if xj == w:
                    continue
                m = [xj]
                li = 0
                while li < len(m):
                    if bad:
                        break
                    for e2 in outs(m[li]):
                        z = int(to_right[e2])
                        if z == xj:
                            bad = True
                            break
                        if z == w:
                            continue
                        if z not in m:
                            m.append(z)
                    li += 1
            if bad:
                continue
            xs.append(x)
            ex2.append(w)
        if not ex2:
            continue
        lens = [len(x) for x in xs]
        order = np.argsort(lens, kind="stable")
        if len(ex2) >= 2 and lens[order[0]] == lens[order[1]]:
            continue
        bounds.append((v, ex2[order[0]]))
    return sorted(bounds)


def edge_paths(hbv, v, w, max_paths):
    """All edge paths v -> w (digraphE::EdgePaths equivalent).

    Returns (ok, paths); not-ok when enumeration exceeds max_paths."""
    outs, ins = _adj(hbv)
    to_right = hbv.to_right
    paths = []
    stack = [(v, [])]
    while stack:
        u, pref = stack.pop()
        if u == w and pref:
            paths.append(pref)
            if len(paths) > max_paths:
                return False, []
            # paths may continue through w? reference stops at w
            continue
        if len(pref) > 64:  # cells are small; guard runaway
            return False, []
        for e in outs(u):
            stack.append((int(to_right[e]), pref + [int(e)]))
        if len(stack) > 16 * max_paths + 64:
            return False, []
    return True, paths


# ---------------------------------------------------------------------------
# FindLines
# ---------------------------------------------------------------------------


def find_lines(hbv, max_cell_paths: int = 50, max_depth: int = 10):
    """FindLines (Lines.cc:23).  Returns list of lines; line = list of
    cells; cell = list of edge-id lists."""
    inv = hbv.inv
    E = hbv.n_edges
    to_left, to_right = hbv.to_left, hbv.to_right
    outs, ins = _adj(hbv)

    bounds0 = find_some_cells(hbv, 2 * max_cell_paths, max_depth)
    # symmetrize
    sym = set(bounds0)
    for v, w in bounds0:
        rv = int(to_right[inv[outs(v)[0]]])
        rw = int(to_left[inv[ins(w)[0]]])
        sym.add((rw, rv))
    bounds = sorted(sym)

    xpaths = []
    keep_bounds = []
    for v, w in bounds:
        ok, ps = edge_paths(hbv, v, w, max_cell_paths)
        if ok and len(ps) <= max_cell_paths:
            xpaths.append(ps)
            keep_bounds.append((v, w))
    bounds = keep_bounds

    # remove subset cells (contents = {IFrom(v,0), ITo(w,0)} + path edges,
    # Lines.cc:104-112)
    contents = []
    for (v, w), ps in zip(bounds, xpaths):
        s = {int(outs(v)[0]), int(ins(w)[0])}
        for p in ps:
            s.update(p)
        contents.append(s)
    xdel = [False] * len(bounds)
    cell_index = {}
    for ci, s in enumerate(contents):
        for e in s:
            cell_index.setdefault(e, []).append(ci)
    for e, cis in cell_index.items():
        for c1 in cis:
            if xdel[c1]:
                continue
            for c2 in cis:
                if c1 == c2 or xdel[c2]:
                    continue
                if bounds[c1][1] == bounds[c2][0]:
                    continue
                if bounds[c2][1] == bounds[c1][0]:
                    continue
                if len(contents[c1]) >= len(contents[c2]):
                    continue
                if contents[c1] <= contents[c2]:
                    xdel[c1] = True
    bounds = [b for b, d in zip(bounds, xdel) if not d]
    xpaths = [p for p, d in zip(xpaths, xdel) if not d]

    # gap cells (0-length gap edges between 1-1 vertices; step-7 artifact)
    elen = hbv.edge_len()
    for e in range(E):
        v = int(to_right[e])
        if len(ins(v)) != 1 or len(outs(v)) != 1:
            continue
        f = int(outs(v)[0])
        if elen[f] != 0:
            continue
        w = int(to_right[f])
        if len(ins(w)) != 1 or len(outs(w)) != 1:
            continue
        bounds.append((v, w))
        xpaths.append([[]])

    order = np.argsort(
        np.array([b[0] * (hbv.n_vertices + 1) + b[1] for b in bounds])
        if bounds
        else np.zeros(0)
    )
    bounds = [bounds[i] for i in order]
    xpaths = [xpaths[i] for i in order]
    left_ind = {}
    right_ind = {}
    for i, (v, w) in enumerate(bounds):
        left_ind.setdefault(v, []).append(i)
        right_ind.setdefault(w, []).append(i)

    # build lines from longest edges first
    ids = np.argsort(-elen, kind="stable")
    marked = np.zeros(E, dtype=bool)
    lines = []
    for e in ids:
        e = int(e)
        if elen[e] == 0 or marked[e]:
            continue
        marked[e] = True
        line = [[[e]]]
        circle = False
        while True:
            w = int(to_left[line[0][0][0]])
            if len(outs(w)) != 1 or len(right_ind.get(w, [])) != 1:
                break
            bid = right_ind[w][0]
            v = bounds[bid][0]
            line.insert(0, xpaths[bid])
            eb = int(ins(v)[0])
            line.insert(0, [[eb]])
            marked[eb] = True
            for p in xpaths[bid]:
                for x in p:
                    marked[x] = True
            if eb == e:
                circle = True
                break
        if not circle:
            while True:
                v = int(to_right[line[-1][0][0]])
                if len(ins(v)) != 1 or len(left_ind.get(v, [])) != 1:
                    break
                bid = left_ind[v][0]
                w = bounds[bid][1]
                eb = int(outs(w)[0])
                line.append(xpaths[bid])
                line.append([[eb]])
                marked[eb] = True
                for p in xpaths[bid]:
                    for x in p:
                        marked[x] = True

        # rc mirror
        liner = []
        for cell in reversed(line):
            liner.append([[int(inv[x]) for x in reversed(p)] for p in cell])
        lines.append(line)
        lines.append(liner)

    # order paths within cells; dedupe identical-content lines
    for line in lines:
        for cell in line:
            cell.sort()
    seen = {}
    for i, line in enumerate(lines):
        key = tuple(
            sorted(set(x for cell in line for p in cell for x in p))
        )
        if key not in seen:
            seen[key] = i
    lines = [lines[i] for i in sorted(seen.values())]

    # remove subset lines (longest owner of each edge wins)
    llen = [
        sum(len(p) for cell in line for p in cell) for line in lines
    ]
    order = np.argsort(-np.array(llen), kind="stable") if lines else []
    lines = [lines[i] for i in order]
    owner = {}
    to_delete = set()
    for i, line in enumerate(lines):
        for cell in line:
            for p in cell:
                for x in p:
                    if x in owner and owner[x] != i:
                        to_delete.add(i)
                    else:
                        owner[x] = i
    lines = [l for i, l in enumerate(lines) if i not in to_delete]
    return lines


# ---------------------------------------------------------------------------
# lengths / emission
# ---------------------------------------------------------------------------


def _path_len_kmers(hbv, p):
    kmers = hbv.edge_kmers()
    return int(np.sum(kmers[p])) if len(p) else 0


def get_line_lengths(hbv, lines):
    """GetLineLengths (Lines.h:80-128): sum over cells of the median
    path length (kmers); 2-path cells average."""
    out = []
    for line in lines:
        total = 0
        for cell in line:
            pl = sorted(_path_len_kmers(hbv, p) for p in cell)
            npaths = len(pl)
            if npaths == 1:
                total += pl[0]
            elif npaths == 2:
                total += (pl[0] + pl[1]) // 2
            elif npaths:
                if npaths % 2:
                    total += pl[npaths // 2]
                else:
                    total += (pl[npaths // 2] + pl[npaths // 2 - 1]) // 2
        out.append(total)
    return np.array(out, dtype=np.int64)


def line_seq(hbv, line):
    """Flattened most-likely sequence of a line (no read votes: first
    path); use dump_line_files for the voted version."""
    k = hbv.k
    seq = []
    for j, cell in enumerate(line):
        p = cell[0]
        if not p:
            continue
        for e in p:
            s = hbv.edge_seq(int(e))
            seq.extend(s.tolist() if not seq else s[k - 1 :].tolist())
    return np.array(seq, dtype=np.uint8)


def dump_line_files(hbv, lines, out_dir, prefix="a", paths=None):
    """DumpLineFiles (Lines.cc:680): a.lines.fasta, one record per line
    pair (skip rc duplicates), most-likely bubble path by read votes
    when paths are given, 100 Ns per gap cell."""
    GAP = 100
    k = hbv.k
    inv = hbv.inv
    pi_off = pi_read = None
    if paths is not None:
        from ..paths.read_paths import invert_paths

        pi_off, pi_read = invert_paths(paths, hbv.n_edges)

    written = 0
    with open(f"{out_dir}/{prefix}.lines.fasta", "w") as f:
        for i, L in enumerate(lines):
            if i > 0 and lines[i - 1][0][0][0] == int(inv[L[-1][0][0]]):
                continue
            circular1 = len(L) > 1 and L[0][0][0] == L[-1][0][0]
            seq_parts = []
            for j, cell in enumerate(L):
                if circular1 and j == len(L) - 1:
                    break
                if len(cell) == 1 and len(cell[0]) == 0:
                    seq_parts.append("N" * GAP)
                    continue
                best = 0
                if j % 2 == 1 and len(cell) > 1 and paths is not None:
                    best = _vote_best_path(
                        hbv, L, j, cell, paths, pi_off, pi_read, inv
                    )
                b = _cat(hbv, cell[best])
                if j < len(L) - 1:
                    b = b[: len(b) - (k - 1)]
                seq_parts.append(codes_to_seq(b))
            header = f">line_{i}" + (" circular" if circular1 else "")
            f.write(header + "\n")
            s = "".join(seq_parts)
            for x in range(0, len(s), 80):
                f.write(s[x : x + 80] + "\n")
            written += 1
    return written


def _cat(hbv, p):
    k = hbv.k
    b = hbv.edge_seq(int(p[0])).copy()
    for e in p[1:]:
        b = np.concatenate([b, hbv.edge_seq(int(e))[k - 1 :]])
    return b


def _vote_best_path(hbv, L, j, cell, paths, pi_off, pi_read, inv):
    """Read votes for bubble paths (Lines.cc:712-766): reads entering
    from the left edge that match exactly one path vote for it."""
    e = int(L[j - 1][0][0])
    cov = np.zeros(len(cell), dtype=np.int64)
    for pass_ in (1, 2):
        d = e if pass_ == 1 else int(inv[e])
        for ii in range(pi_off[d], pi_off[d + 1]):
            rid = int(pi_read[ii])
            q = paths.path(rid)
            p = (
                [int(x) for x in q]
                if pass_ == 1
                else [int(inv[x]) for x in q[::-1]]
            )
            for m in range(len(p)):
                if p[m] != e:
                    continue
                match = []
                for r, pr in enumerate(cell):
                    ok = True
                    for s_, xe in enumerate(pr):
                        if m + 1 + s_ >= len(p):
                            break
                        if p[m + 1 + s_] != xe:
                            ok = False
                            break
                    if ok:
                        match.append(r)
                if len(match) == 1:
                    cov[match[0]] += 1
    return int(np.argmax(cov))


def sort_lines(hbv, lines):
    """SortLines (Lines.cc:664): descending by line length."""
    lens = get_line_lengths(hbv, lines)
    order = np.argsort(-lens, kind="stable")
    return [lines[i] for i in order]


def write_stats(hbv, lines, out_dir: str):
    """FinalFiles stats (FinalFiles.cc:75-105): N50 (>=1kb lines, +K-1)
    and total bases in >=1kb/10kb/100kb lines."""
    k = hbv.k
    inv = hbv.inv
    lens = []
    for i, L in enumerate(lines):
        if i > 0 and lines[i - 1][0][0][0] == int(inv[L[-1][0][0]]):
            continue
        lens.append(int(get_line_lengths(hbv, [L])[0]) + k - 1)
    lens = np.array(lens, dtype=np.int64)
    stats = {
        "contig_line_N50": n50(lens, min_len=1000),
        "total_bases_1kb_plus": int(lens[lens >= 1000].sum()),
        "total_bases_10kb_plus": int(lens[lens >= 10000].sum()),
        "total_bases_100kb_plus": int(lens[lens >= 100000].sum()),
        "n_lines": int(len(lens)),
    }
    with open(f"{out_dir}/stats", "w") as f:
        for kk, vv in stats.items():
            f.write(f"{kk}: {vv}\n")
    return stats
