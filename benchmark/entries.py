"""The port's public entry points that a traffic mix can drive.

A mix file names one of ENTRIES.  An entry is built once at set-up from
the configuration and the generated reads, runs one pass at a time, and
after the window judges what the passes produced against the plain
reference (benchmark/reference/), which recomputes everything from the
same reads.  The harness imports the port here, when an entry is built,
and for the span log of a traced run (run.py), nowhere else.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import count as ref_count
from .reference import graph as ref_graph


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rows_off(a: list, b: list) -> int:
    """Rows in one multiset and not the other: a and b are lists of equal
    length of (m,) int64 tensors on one device, one tensor a column."""
    rows = torch.cat([torch.stack(a, 1), torch.stack(b, 1)])
    tag = torch.cat([torch.ones(a[0].numel(), dtype=torch.int64, device=rows.device),
                     -torch.ones(b[0].numel(), dtype=torch.int64, device=rows.device)])
    if rows.shape[0] == 0:
        return 0
    _, inv = torch.unique(rows, dim=0, return_inverse=True)
    net = torch.zeros(int(inv.max()) + 1, dtype=torch.int64, device=rows.device)
    net.index_add_(0, inv, tag)
    return int(net.abs().sum())


class CountKmers:
    """ops.kmer_engine.count_kmers_batched, called as step 2
    (pipeline.step2_small_k.build_read_q_graph) calls it: one pass is the
    host pack, the upload, K1, the sort, K2 and the compaction into the
    device-resident dictionary, with its small_K.freqs histogram.

    The work of a pass is the input's windows, reads x (read_len - k + 1),
    whatever the program masks.  Judged: the last pass's dictionary
    (canonical words, saturated counts, contexts) row by row, and every
    pass's histogram, against the reference's."""

    def __init__(self, cfg: dict, reads, device):
        from w2rap_contigger_tpu_torch.ops import kmer_engine

        self.ke = kmer_engine
        self.a = cfg["assembly"]
        self.reads = reads
        self.dev = torch.device(device)
        n, L = reads[0].shape
        self.k = int(self.a["k"])
        self.work = n * max(0, L - self.k + 1)
        self.hists: list[np.ndarray] = []

    def run_pass(self):
        bases, lengths, quals = self.reads
        a = self.a
        out = self.ke.count_kmers_batched(
            bases, lengths, quals, self.k, min_qual=int(a["min_qual"]),
            min_freq=int(a["min_freq"]), chunk_reads=int(a["chunk_reads"]),
            disk_batches=int(a["disk_batches"]), tmp_dir=None,
            max_mem_gb=int(a["max_mem_gb"]), device=self.dev,
        )
        _sync(self.dev)
        return out

    def record(self, out) -> None:
        """Keep what every pass is judged by: its histogram (host)."""
        self.hists.append(np.asarray(out[1], dtype=np.int64).copy())

    def keep(self, out) -> dict:
        """The last pass's dictionary as the reference's columns (hi, lo,
        count, ctx) on the host, and every pass's histogram."""
        d = out[0]
        hi, lo = ref_count.keys_of_words(d.words)
        return {"cols": [t.cpu() for t in (hi, lo, d.cnt, d.ctx)], "hists": self.hists}

    def reference(self, keys: str = "full") -> dict:
        bases, lengths, quals = self.reads
        return ref_count.count(bases, quals, lengths, self.k, int(self.a["min_qual"]),
                               int(self.a["min_freq"]), device=self.dev, keys=keys)

    def control(self, ref: dict) -> dict:
        """The control in the program's place, as keep() gives a pass: the
        reference counting k-mers on their first 32 bases alone (64 of
        the 120 bits), the comparator a faster sort would be tempted to
        take, which breaks the guarantee of exact counts."""
        c = self.reference(keys="hi")
        return {"cols": [c["hi"], c["lo"], c["count"], c["ctx"]], "hists": [c["hist"].numpy()]}

    def judge(self, kept: dict, ref: dict) -> tuple[dict, int]:
        """({check name: value}, passes judged wrong): the kept dictionary
        row by row and every pass's histogram against the reference's."""
        got = [t.to(self.dev) for t in kept["cols"]]
        dict_off = rows_off(got, [ref["hi"], ref["lo"], ref["count"], ref["ctx"]])
        want_hist = ref["hist"].numpy()
        per_pass = [int(np.abs(h - want_hist).sum()) for h in kept["hists"]]
        failed = sum(1 for v in per_pass if v) + (1 if dict_off and not per_pass[-1] else 0)
        return {"dict_rows_off": dict_off, "hist_bins_off": sum(per_pass)}, failed

    def shapes(self, ref: dict) -> dict:
        """What the roofline readers need of a pass."""
        n, L = self.reads[0].shape
        return {"reads": n, "read_len": L, "k": self.k, "k2_rows": ref["windows"]}

    def notes(self, ref: dict) -> dict:
        """What the reference found, for the record."""
        return {"windows": ref["windows"], "kmers": ref["hi"].numel()}


def paths_off(a, b, skip: set) -> int:
    """Reads whose (edges, start) differ between two (offsets, flat,
    starts) triples, leaving out the reads in skip."""
    (oa, fa, sa), (ob, fb, sb) = a, b
    la, lb = np.diff(oa), np.diff(ob)
    bad = (la != lb) | (sa != sb)
    same_len = np.flatnonzero(~bad & (la > 0))
    if same_len.size:
        rows = np.repeat(same_len, la[same_len])
        local = np.arange(rows.size) - np.repeat(np.cumsum(la[same_len]) - la[same_len],
                                                 la[same_len])
        diff = fa[oa[rows] + local] != fb[ob[rows] + local]
        bad[np.unique(rows[diff])] = True
    if skip:
        bad[list(skip)] = False
    return int(bad.sum())


class SmallKGraph:
    """pipeline.step2_small_k.build_read_q_graph whole, at the assembler's
    defaults: the count, adjacencies, unitigs, HBV, read pathing and path
    extension.  The work of a pass is its reads.  Judged: the last pass's
    dictionary (with its pruned contexts), the graph's edges and links up
    to numbering, and every read's extended path, against the reference;
    and every pass's sizes (dictionary rows, edges, path entries)."""

    def __init__(self, cfg: dict, reads, device):
        from w2rap_contigger_tpu_torch.core.reads import ReadSet
        from w2rap_contigger_tpu_torch.pipeline import step2_small_k

        self.step2 = step2_small_k
        self.a = cfg["assembly"]
        self.rs = ReadSet(*reads)
        self.reads = reads
        self.dev = torch.device(device)
        self.k = int(self.a["k"])
        self.work = reads[0].shape[0]
        self.sizes: list[tuple] = []

    def run_pass(self):
        a = self.a
        out = self.step2.build_read_q_graph(
            self.rs, min_qual=int(a["min_qual"]), min_freq=int(a["min_freq"]), k=self.k,
            chunk_reads=int(a["chunk_reads"]), disk_batches=int(a["disk_batches"]),
            max_mem_gb=int(a["max_mem_gb"]), device=self.dev,
        )
        _sync(self.dev)
        return out

    def record(self, out) -> None:
        hbv, paths, d = out
        self.sizes.append((d.size, hbv.n_edges, len(paths.edges)))

    def keep(self, out) -> dict:
        """The last pass as the reference's columns and the graph by
        digest: edges, their vertices, and the paths over those edges."""
        hbv, paths, d = out
        hi, lo = ref_count.keys_of_words(d.words)
        return {"cols": [t.cpu() for t in (hi, lo, d.cnt, d.ctx)],
                "digests": [ref_graph.digest(hbv.edge_bases[a:b])
                            for a, b in zip(hbv.edge_start[:-1], hbv.edge_start[1:])],
                "left": np.asarray(hbv.to_left), "right": np.asarray(hbv.to_right),
                "paths": tuple(np.asarray(x, dtype=np.int64)
                               for x in (paths.offsets, paths.edges, paths.start)),
                "sizes": self.sizes}

    def reference(self, keys: str = "full") -> dict:
        bases, lengths, quals = self.reads
        a = self.a
        return ref_graph.small_k_graph(bases, quals, lengths, self.k, int(a["min_qual"]),
                                       int(a["min_freq"]), device=self.dev, keys=keys)

    def control(self, ref: dict) -> dict:
        """The control in the program's place: the reference's graph and
        paths over a dictionary counted on the k-mers' first 32 bases
        alone (CountKmers.control)."""
        c = self.reference(keys="hi")
        cnt, g = c["count"], c["graph"]
        return {"cols": [cnt["hi"], cnt["lo"], cnt["count"], cnt["ctx"]], "digests": g.digests,
                "left": g.left, "right": g.right, "paths": (c["offsets"], c["edges"], c["starts"]),
                "sizes": [(cnt["hi"].numel(), len(g.seqs), int(c["offsets"][-1]))]}

    def judge(self, kept: dict, ref: dict) -> tuple[dict, int]:
        c, g = ref["count"], ref["graph"]
        got = [t.to(self.dev) for t in kept["cols"]]
        dict_off = rows_off(got, [c["hi"], c["lo"], c["count"], c["ctx"]])
        pe, pl = ref_graph.graph_signature(kept["digests"], kept["left"], kept["right"])
        re_, rl = ref_graph.graph_signature(g.digests, g.left, g.right)
        edges_off = sum(((pe - re_) + (re_ - pe)).values())
        links_off = sum(((pl - rl) + (rl - pl)).values())
        ids = {dg: i for i, dg in enumerate(g.digests)}
        as_ref = np.array([ids.get(dg, -1) for dg in kept["digests"]], dtype=np.int64)
        po, pf, ps = kept["paths"]
        p_off = paths_off((po, as_ref[pf], ps), (ref["offsets"], ref["edges"], ref["starts"]),
                          ref["ambiguous"])
        want = (c["hi"].numel(), len(g.seqs), int(ref["offsets"][-1]))
        size_off = [sum(abs(x - y) for x, y in zip(s, want)) for s in kept["sizes"]]
        failed = sum(1 for v in size_off if v)
        if (dict_off or edges_off or links_off or p_off) and not size_off[-1]:
            failed += 1
        return {"dict_rows_off": dict_off, "graph_edges_off": edges_off,
                "graph_links_off": links_off, "paths_off": p_off,
                "pass_sizes_off": sum(size_off)}, failed

    def shapes(self, ref: dict) -> dict:
        n, L = self.reads[0].shape
        return {"reads": n, "read_len": L, "k": self.k, "k2_rows": ref["count"]["windows"]}

    def notes(self, ref: dict) -> dict:
        """What the reference found, for the record: the ambiguous reads
        are left out of paths_off."""
        return {"windows": ref["count"]["windows"], "kmers": ref["count"]["hi"].numel(),
                "edges": len(ref["graph"].seqs), "ambiguous_reads": len(ref["ambiguous"])}


ENTRIES = {"count_kmers": CountKmers, "build_read_q_graph": SmallKGraph}
