"""Plain reference of step 2's small-k graph and read paths, written from
the upstream semantics (BuildReadQGraph.cc: AdjProc, the unitig builder,
buildHBVFromEdges, path_reads_OMP and the pather's heuristics;
ExtendReadPath.cc), in plain PyTorch and NumPy.  It starts from the
reference count (count.py) of the same reads and imports nothing of the
program.

1. Adjacencies: a context bit stays where the k-mer it points to (the
   k-mer shifted by one base, taken canonical) is in the dictionary.
2. Unitigs: an oriented k-mer u links to v when u has exactly one
   successor, v is it and has exactly one predecessor, neither is its own
   reverse complement, and v is not u's own reverse complement.  Maximal
   chains of links are the unitigs; of a chain and its mirror (the reverse
   complements in reverse order) the one whose sequence is lesser is kept
   (a single palindromic k-mer: its forward node).  A closed chain is
   rotated to start at its least oriented k-mer, taken in the orientation
   whose sequence is lesser.
3. The graph: each unitig and, unless it is its own reverse complement,
   its reverse complement; edges meet where one's last k-1 bases are
   another's first k-1.
4. Read paths: every window of a read (positions 0 .. length-k) is looked
   up; consecutive windows on one edge at consecutive offsets form a
   part, consecutive misses a gap part.  At a read's first interior gap
   (between two parts on edges) whose length differs from the distance
   along the graph by more than 3 windows, or whose two edges neither
   match nor end in the same k-1 bases, the read is cut before the gap
   (before the part ahead of it when more than one part on an edge
   precedes it).  A last kept part at offset 0 of its edge and at most 5
   windows long is dropped.  The path is the kept parts' edges without
   repeats; the start is the first part's offset, or when the read begins
   with a gap, the second part's offset less the gap.
5. Extension: a read whose path leaves 10 or more bases unexplained at an
   end tries the edges across the end's vertex, scored base by base from
   the vertex outward (a mismatch adds its quality, 20 for Q2, to a
   penalty and the penalty to the score; a match lowers a penalty by a
   fifth, rounded down; bases past the edge cost 10 each), after the
   upstream gate on short, long and dead-end candidates; the best score
   is taken when it is at most 10 per unexplained base, left ends first,
   then right ends, each until nothing is taken.  Where two candidates
   share the best score, upstream takes the one of lower edge number: the
   answer depends on numbering, and the read is marked ambiguous.

Edges are compared by sequence (a digest of their bases), so numbering
never matters elsewhere.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import count as ref_count

MIN_GAP = 10
MAX_JITTER = 3
WEAK_SEED = 5
Q2_AS = 20
DECAY = 0.2
LEFTOVER = 10
NODE_CHUNK = 1 << 21
READ_CHUNK = 16384


def codes_of_keys(hi: torch.Tensor, lo: torch.Tensor, k: int) -> torch.Tensor:
    """(M, k) uint8 base codes of k-mers held as (hi, lo) keys."""
    cols = []
    for i in range(k):
        v, j = (hi, i) if i < 32 else (lo, i - 32)
        c = (v >> (62 - 2 * j)) & 3
        cols.append(c ^ 2 if j == 0 else c)
    return torch.stack(cols, 1).to(torch.uint8)


def canonical(codes: torch.Tensor, k: int):
    """(hi, lo, is_rev) of the canonical forms of (n, k) k-mer codes."""
    fhi, flo = ref_count._keys(codes, k)
    rhi, rlo = ref_count._keys(3 - codes.flip(-1), k)
    is_rev = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    return torch.where(is_rev, rhi, fhi), torch.where(is_rev, rlo, flo), is_rev


def rc_ctx(ctx: torch.Tensor) -> torch.Tensor:
    """The context of the reverse complement: predecessor and successor
    swap, and each base is complemented (bit b -> bit 3 - b)."""
    def flip4(x):
        return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)
    return (flip4(ctx & 15) << 4) | flip4((ctx >> 4) & 15)


def popcount4(x: torch.Tensor) -> torch.Tensor:
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


class Table:
    """The sorted dictionary's keys with an exact lookup."""

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor):
        self.hi, self.lo = hi, lo
        self.run = int(torch.unique_consecutive(hi, return_counts=True)[1].max()) if hi.numel() else 0

    def find(self, qhi: torch.Tensor, qlo: torch.Tensor):
        """(row, found) of each query."""
        row = torch.zeros_like(qhi)
        found = torch.zeros(qhi.shape, dtype=torch.bool, device=qhi.device)
        if not self.run:
            return row, found
        pos = torch.searchsorted(self.hi, qhi)
        for j in range(self.run):
            r = (pos + j).clamp(max=self.hi.numel() - 1)
            hit = (self.hi[r] == qhi) & (self.lo[r] == qlo) & ~found
            row = torch.where(hit, r, row)
            found |= hit
        return row, found


def prune(table: Table, codes: torch.Tensor, ctx: torch.Tensor, k: int) -> torch.Tensor:
    """Step 1: the contexts with bits to absent k-mers cleared."""
    out = torch.zeros_like(ctx)
    for s in range(0, codes.shape[0], NODE_CHUNK):
        c, x = codes[s : s + NODE_CHUNK], ctx[s : s + NODE_CHUNK]
        new = torch.zeros_like(x)
        for b in range(4):
            base = torch.full((c.shape[0], 1), b, dtype=c.dtype, device=c.device)
            for bit, shifted in ((b, torch.cat([c[:, 1:], base], 1)),
                                 (b + 4, torch.cat([base, c[:, :-1]], 1))):
                h, l_, _ = canonical(shifted, k)
                _, found = table.find(h, l_)
                new |= (((x >> bit) & 1).bool() & found).to(torch.int64) << bit
        out[s : s + NODE_CHUNK] = new
    return out


def links(table: Table, codes: torch.Tensor, ctx: torch.Tensor, k: int) -> torch.Tensor:
    """Step 2's links: nxt (2M,) over oriented nodes n = j + o * M (o = 1:
    the reverse complement of k-mer j), -1 where no link leaves n."""
    M = codes.shape[0]
    fh, fl = ref_count._keys(codes, k)
    rh, rl = ref_count._keys(3 - codes.flip(-1), k)
    pal = (fh == rh) & (fl == rl)
    del fh, fl, rh, rl
    nxt = torch.full((2 * M,), -1, dtype=torch.int64, device=codes.device)
    for o in (0, 1):
        for s in range(0, M, NODE_CHUNK):
            j = torch.arange(s, min(s + NODE_CHUNK, M), device=codes.device)
            oc = codes[j] if o == 0 else 3 - codes[j].flip(-1)
            ox = ctx[j] if o == 0 else rc_ctx(ctx[j])
            succ = ox & 15
            one = popcount4(succ) == 1
            b = ((succ >> 1) & 1) + ((succ >> 2) & 1) * 2 + ((succ >> 3) & 1) * 3
            nc = torch.cat([oc[:, 1:], b[:, None].to(oc.dtype)], 1)
            h, l_, rev = canonical(nc, k)
            v, found = table.find(h, l_)
            vx = torch.where(rev, rc_ctx(ctx[v]), ctx[v])
            hairpin = (v == j) & (rev != bool(o))
            ok = one & found & ~pal[j] & ~pal[v] & (popcount4((vx >> 4) & 15) == 1) & ~hairpin
            nxt[j + o * M] = torch.where(ok, v + rev.to(torch.int64) * M, -1)
    return nxt


def _oriented(codes: torch.Tensor, n: int, M: int) -> np.ndarray:
    c = codes[n % M]
    return (c if n < M else 3 - c.flip(-1)).cpu().numpy()


def unitigs(codes: torch.Tensor, nxt: torch.Tensor, k: int):
    """Step 2's unitigs: (list of uint8 code arrays, kdef (M, 3) int64 of
    each k-mer's unitig, offset and orientation)."""
    M = codes.shape[0]
    dev = codes.device
    n = torch.arange(2 * M, device=dev)
    has = nxt >= 0
    prev = torch.full_like(nxt, -1)
    prev[nxt[has]] = n[has]
    ptr = torch.where(prev >= 0, prev, n)
    rank = (prev >= 0).to(torch.int64)
    for _ in range(max(1, (2 * M).bit_length() + 1)):
        rank = rank + rank[ptr]
        ptr = ptr[ptr]
    cyc = prev[ptr] >= 0
    lin = n[~cyc]
    order = torch.argsort(ptr[lin] * (2 * M) + rank[lin])
    lin = lin[order]
    heads = ptr[lin]
    starts = torch.nonzero(torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                      heads[1:] != heads[:-1]])).flatten()
    ends = torch.cat([starts[1:], torch.tensor([lin.numel()], device=dev)])
    last = torch.where(lin < M, codes[lin % M, k - 1].to(torch.int64),
                       3 - codes[lin % M, 0].to(torch.int64)).to(torch.uint8).cpu().numpy()
    hn = lin[starts]
    head = torch.where((hn < M)[:, None], codes[hn % M], 3 - codes[hn % M].flip(-1)).cpu().numpy()
    lin_h = lin.cpu().numpy()
    edges, kdef = [], np.full((M, 3), -1, dtype=np.int64)
    for i, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
        seq = np.concatenate([head[i, : k - 1], last[a:b]])
        fw, rv = seq.tobytes(), (3 - seq)[::-1].tobytes()
        if fw > rv or (fw == rv and lin_h[a] >= M):
            continue
        nodes = lin_h[a:b]
        kdef[nodes % M] = np.stack([np.full(b - a, len(edges)), np.arange(b - a), nodes // M], 1)
        edges.append(seq)
    todo = set(torch.nonzero(cyc[:M]).flatten().tolist())
    nh = nxt.cpu().numpy()
    while todo:
        chain, c = [], min(todo)
        while True:
            chain.append(c)
            c = int(nh[c])
            if c % M == chain[0] % M:
                break
        todo -= {x % M for x in chain}

        def rotated(ch):
            i = min(range(len(ch)), key=lambda t: _oriented(codes, ch[t], M).tobytes())
            return ch[i:] + ch[:i]

        def spelled(ch):
            return np.concatenate([_oriented(codes, ch[0], M)[: k - 1]] +
                                  [_oriented(codes, x, M)[-1:] for x in ch])

        chain = rotated(chain)
        seq = spelled(chain)
        if (3 - seq)[::-1].tobytes() < seq.tobytes():
            chain = rotated([(x + M) % (2 * M) for x in reversed(chain)])
            seq = spelled(chain)
        for i, x in enumerate(chain):
            kdef[x % M] = (len(edges), i, x // M)
        edges.append(seq)
    if (kdef[:, 0] < 0).any():
        raise RuntimeError("reference: a k-mer lies on no unitig")
    return edges, kdef


def digest(seq: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(seq, dtype=np.uint8).tobytes(),
                           digest_size=16).digest()


class Graph:
    """Step 3: the edges in both orientations, their vertices and digests."""

    def __init__(self, unitig_seqs: list, k: int):
        self.k = k
        self.seqs, fwd, rev = [], [], []
        for s in unitig_seqs:
            fwd.append(len(self.seqs))
            self.seqs.append(s)
            r = (3 - s)[::-1]
            if np.array_equal(r, s):
                rev.append(fwd[-1])
            else:
                rev.append(len(self.seqs))
                self.seqs.append(np.ascontiguousarray(r))
        self.fwd, self.rev = np.array(fwd, dtype=np.int64), np.array(rev, dtype=np.int64)
        vid: dict = {}
        E = len(self.seqs)
        self.left = np.array([vid.setdefault(s[: k - 1].tobytes(), len(vid)) for s in self.seqs],
                             dtype=np.int64).reshape(E)
        self.right = np.array([vid.setdefault(s[len(s) - k + 1 :].tobytes(), len(vid))
                               for s in self.seqs], dtype=np.int64).reshape(E)
        self.n_vertices = len(vid)
        self.elen = np.array([len(s) for s in self.seqs], dtype=np.int64).reshape(E)
        self.ekm = self.elen - k + 1
        self.digests = [digest(s) for s in self.seqs]


def graph_signature(digests: list, left: np.ndarray, right: np.ndarray):
    """(edge multiset, link multiset) of a graph: edges by digest, links
    as (digest, digest) pairs where one edge's right vertex is the
    other's left."""
    from collections import Counter

    into: dict = {}
    for e, v in enumerate(right.tolist()):
        into.setdefault(v, []).append(e)
    pairs = Counter()
    for b, v in enumerate(left.tolist()):
        for a in into.get(v, ()):
            pairs[(digests[a], digests[b])] += 1
    return Counter(digests), pairs


def _parts(bases, lengths, table: Table, kdef_t: torch.Tensor, fwd_t, rev_t, ekm_t, k: int):
    """Step 4's parts of every read, in read and position order (host
    numpy): read, position, edge (-1 in a gap), offset, edge k-mers,
    length in windows."""
    dev = kdef_t.device
    out = {n: [] for n in ("rid", "pos", "e", "off", "ekm", "len")}
    L = bases.shape[1]
    P = L - k + 1
    if P <= 0:
        return {n: np.zeros(0, np.int64) for n in out}
    ar = torch.arange(k, device=dev)
    pos_all = torch.arange(P, device=dev)
    for r0 in range(0, bases.shape[0], READ_CHUNK):
        b = torch.as_tensor(bases[r0 : r0 + READ_CHUNK]).to(dev)
        ln = torch.as_tensor(lengths[r0 : r0 + READ_CHUNK]).to(dev).to(torch.int64)
        n = b.shape[0]
        win = b[:, pos_all[:, None] + ar[None, :]]  # (n, P, k)
        h, l_, rev = canonical(win.reshape(n * P, k), k)
        del win
        row, found = table.find(h, l_)
        del h, l_
        kd = kdef_t[row]
        flip = rev ^ kd[:, 2].bool()
        e = torch.where(flip, rev_t[kd[:, 0]], fwd_t[kd[:, 0]])
        ekm = ekm_t[kd[:, 0]]
        off = torch.where(flip, ekm - 1 - kd[:, 1], kd[:, 1])
        e = torch.where(found, e, -1).reshape(n, P)
        off, ekm = off.reshape(n, P), ekm.reshape(n, P)
        n_valid = (ln - k + 1).clamp(min=0)
        valid = pos_all[None, :] < n_valid[:, None]
        pe = torch.cat([torch.full((n, 1), -3, device=dev, dtype=e.dtype), e[:, :-1]], 1)
        po = torch.cat([torch.zeros((n, 1), device=dev, dtype=off.dtype), off[:, :-1]], 1)
        new = valid & ((e != pe) | ((e >= 0) & (off != po + 1)))
        rid, pos = torch.nonzero(new, as_tuple=True)
        nxt_pos = torch.cat([pos[1:], pos.new_zeros(1)])
        last = torch.cat([rid[1:] != rid[:-1], torch.ones(1, dtype=torch.bool, device=dev)]) \
            if rid.numel() else rid.new_zeros(0, dtype=torch.bool)
        plen = torch.where(last, n_valid[rid] - pos, nxt_pos - pos)
        for name, t in (("rid", rid + r0), ("pos", pos), ("e", e[rid, pos]),
                        ("off", off[rid, pos]), ("ekm", ekm[rid, pos]), ("len", plen)):
            out[name].append(t.cpu().numpy().astype(np.int64))
    return {name: np.concatenate(v) if v else np.zeros(0, np.int64) for name, v in out.items()}


def paths_from_parts(p: dict, n_reads: int, tails: np.ndarray):
    """Step 4's heuristics: (offsets (n+1,), flat edges, starts (n,))."""
    rid, e, off, plen, ekm = p["rid"], p["e"], p["off"], p["len"], p["ekm"]
    N = rid.size
    seed = e >= 0
    first = np.ones(N, dtype=bool)
    first[1:] = rid[1:] != rid[:-1]
    lastp = np.ones(N, dtype=bool)
    lastp[:-1] = rid[1:] != rid[:-1]
    begin = np.flatnonzero(first)
    local = np.arange(N) - np.repeat(begin, np.diff(np.append(begin, N)))
    pi = np.clip(np.arange(N) - 1, 0, max(N - 1, 0))
    ni = np.clip(np.arange(N) + 1, 0, max(N - 1, 0))
    interior = ~seed & ~first & ~lastp & seed[pi] & seed[ni]
    same = e[pi] == e[ni]
    dist = off[ni] - (off[pi] + plen[pi]) + np.where(same, 0, ekm[pi])
    join = same | (tails[np.clip(e[pi], 0, None)] == tails[np.clip(e[ni], 0, None)])
    bad = interior & ~((np.abs(plen - dist) <= MAX_JITTER) & join)
    big = np.iinfo(np.int64).max
    first_bad = np.full(n_reads, big)
    np.minimum.at(first_bad, rid[bad], local[bad])
    seeds_before = np.cumsum(seed) - seed
    seeds_before -= np.repeat(seeds_before[begin], np.diff(np.append(begin, N)))
    at_bad = bad & (local == first_bad[rid])
    cut = np.full(n_reads, big)
    cut[rid[at_bad]] = np.where(seeds_before[at_bad] > 1, local[at_bad] - 1, local[at_bad])
    keep = local < cut[rid]
    ks = np.flatnonzero(keep & seed)
    last_seed = np.full(n_reads, -1)
    np.maximum.at(last_seed, rid[ks], ks)
    ls = last_seed[last_seed >= 0]
    keep[ls[(off[ls] == 0) & (plen[ls] <= WEAK_SEED)]] = False
    ks = np.flatnonzero(keep & seed)
    dup = np.zeros(ks.size, dtype=bool)
    dup[1:] = (rid[ks][1:] == rid[ks][:-1]) & (e[ks][1:] == e[ks][:-1])
    ks = ks[~dup]
    counts = np.bincount(rid[ks], minlength=n_reads)
    offsets = np.zeros(n_reads + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)
    start = np.zeros(n_reads, dtype=np.int64)
    f_seed = begin[seed[begin]]
    start[rid[f_seed]] = off[f_seed]
    f_gap = begin[~seed[begin]]
    sec = f_gap + 1
    ok = (sec < N) & (rid[np.clip(sec, 0, max(N - 1, 0))] == rid[f_gap])
    sec, f_gap = sec[ok], f_gap[ok]
    ok = keep[sec] & seed[sec]
    start[rid[f_gap[ok]]] = off[sec[ok]] - plen[f_gap[ok]]
    start[counts == 0] = 0
    return offsets, e[ks], start


def _score(g: Graph, rb, rq, rlen, cand, gap, left: bool) -> float:
    """A candidate edge's score for one read's unexplained end."""
    s = g.seqs[cand]
    k = g.k
    ncmp = min(gap, int(g.elen[cand]) - (k - 1))
    score, pen = 0.0, 0.0
    for t in range(ncmp):
        ri, ei = (gap - 1 - t, len(s) - k - t) if left else (rlen - gap + t, k - 1 + t)
        if rb[ri] != s[ei]:
            pen += Q2_AS if rq[ri] == 2 else float(rq[ri])
            score += pen
        elif pen > 0:
            pen = np.floor(pen - DECAY * pen)
    return score + max(gap - (int(g.elen[cand]) - (k - 1)), 0) * LEFTOVER


def _extend_one(g: Graph, ins: dict, outs: dict, rb, rq, rlen: int, p: list, start: int,
                left: bool):
    """One read's extensions at one end: (path, start, ambiguous)."""
    k = g.k
    ambiguous = False
    while True:
        if left:
            gap = -start
            cands = ins.get(int(g.left[p[0]]), [])
            dest = [int(g.left[c]) for c in cands]
            hang = [len(ins.get(d, [])) == 0 and len(outs.get(d, [])) == 1 for d in dest]
            dest_deg = [len(ins.get(d, [])) for d in dest]
        else:
            gap = rlen + start - int(g.ekm[p].sum()) - (k - 1)
            cands = outs.get(int(g.right[p[-1]]), [])
            dest = [int(g.right[c]) for c in cands]
            hang = [len(outs.get(d, [])) == 0 and len(ins.get(d, [])) == 1 for d in dest]
            dest_deg = [len(outs.get(d, [])) for d in dest]
        if gap < MIN_GAP or not cands:
            break
        longs = [int(g.elen[c]) - (k - 1) >= gap for c in cands]
        short = [not lg and not hg for lg, hg in zip(longs, hang)]
        if len(cands) > 1 and any(short):
            sd = {(d, dd) for d, dd, s in zip(dest, dest_deg, short) if s}
            if any(longs) or len(sd) != 1 or next(iter(sd))[1] != 1:
                break
        scored = [(c, _score(g, rb, rq, rlen, c, gap, left))
                  for c, hg in zip(cands, hang) if not hg or len(cands) == 1]
        if not scored:
            break
        best = min(sc for _, sc in scored)
        if best > 10 * gap:
            break
        ambiguous |= sum(1 for _, sc in scored if sc == best) > 1
        e = next(c for c, sc in scored if sc == best)
        if left:
            p = [e] + p
            start += int(g.ekm[e])
        else:
            p = p + [e]
    return p, start, ambiguous


def extend(g: Graph, bases, quals, lengths, offsets, flat, starts):
    """Step 5: (offsets, flat, starts) with every extension made, and the
    reads marked ambiguous.  Only reads whose unexplained end reaches
    MIN_GAP are walked, left ends first."""
    k = g.k
    outs: dict = {}
    ins: dict = {}
    for e in range(len(g.seqs)):
        outs.setdefault(int(g.left[e]), []).append(e)
        ins.setdefault(int(g.right[e]), []).append(e)
    n = starts.size
    plen = np.diff(offsets)
    ksum = np.zeros(n, dtype=np.int64)
    np.add.at(ksum, np.repeat(np.arange(n), plen), g.ekm[flat])
    rgap = lengths.astype(np.int64) + starts - ksum - (k - 1)
    todo = np.flatnonzero((plen > 0) & ((-starts >= MIN_GAP) | (rgap >= MIN_GAP)))
    changed, ambiguous = {}, set()
    for r in todo.tolist():
        p, st = flat[offsets[r] : offsets[r + 1]].tolist(), int(starts[r])
        amb = False
        for left in (True, False):
            p, st, a = _extend_one(g, ins, outs, bases[r], quals[r], int(lengths[r]), p, st, left)
            amb |= a
        if amb:
            ambiguous.add(r)
        changed[r] = (p, st)
    if not changed:
        return offsets, flat, starts, ambiguous
    lens = plen.copy()
    starts = starts.copy()
    for r, (p, st) in changed.items():
        lens[r] = len(p)
        starts[r] = st
    new_off = np.zeros(n + 1, dtype=np.int64)
    new_off[1:] = np.cumsum(lens)
    keep = np.ones(n, dtype=bool)
    keep[list(changed)] = False
    src = np.repeat(keep, plen)
    dst_rows = np.repeat(np.arange(n), plen)[src]
    new_flat = np.zeros(int(new_off[-1]), dtype=np.int64)
    local = np.arange(flat.size) - np.repeat(offsets[:-1], plen)
    new_flat[new_off[dst_rows] + local[src]] = flat[src]
    for r, (p, _) in changed.items():
        new_flat[new_off[r] : new_off[r + 1]] = p
    return new_off, new_flat, starts, ambiguous


def small_k_graph(bases, quals, lengths, k: int, min_qual: int, min_freq: int, device="cpu",
                  keys: str = "full"):
    """Steps 1-5 from host read arrays: a dict with the count (`count`,
    its `ctx` replaced by the pruned contexts), the `graph` (Graph), the
    read paths (`offsets`, `edges` as indices into graph.seqs, `starts`)
    and the set of `ambiguous` reads."""
    dev = torch.device(device)
    cnt = ref_count.count(bases, quals, lengths, k, min_qual, min_freq, device=dev, keys=keys)
    table = Table(cnt["hi"], cnt["lo"])
    codes = codes_of_keys(cnt["hi"], cnt["lo"], k)
    cnt["ctx"] = prune(table, codes, cnt["ctx"], k)
    edges, kdef = unitigs(codes, links(table, codes, cnt["ctx"], k), k)
    del codes
    g = Graph(edges, k)
    tail_id: dict = {}
    tails = np.array([tail_id.setdefault(q[len(q) - k + 1 :].tobytes(), len(tail_id))
                      for q in g.seqs], dtype=np.int64)
    parts = _parts(bases, lengths, table, torch.as_tensor(kdef).to(dev),
                   torch.as_tensor(g.fwd).to(dev), torch.as_tensor(g.rev).to(dev),
                   torch.as_tensor(g.ekm[g.fwd]).to(dev), k)
    offsets, flat, starts = paths_from_parts(parts, bases.shape[0], tails)
    offsets, flat, starts, ambiguous = extend(g, bases, quals, lengths, offsets, flat, starts)
    return {"count": cnt, "graph": g, "offsets": offsets, "edges": flat, "starts": starts,
            "ambiguous": ambiguous}
