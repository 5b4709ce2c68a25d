"""Steps 6-7's host modules (Simplify's passes, PathFinder, MakeGaps,
coverage, GFA) of the port against the JAX package's, exactly.

The graphs are the ones the JAX package's own tests build
(test_simplify_late_passes.py, test_pathfinder.py,
test_simplify_passes.py, test_makegaps.py), from the same seeds; those
built from reads go through the port's plain (CPU) count, graph and
pather, so no JAX is compiled here.  Each case hands the same graph,
paths and reads to the JAX module and to its copy in the port and holds
every array of the results equal; each case also asserts that its pass
changed the graph.  The last test runs step 7 of both pipelines
(--from_step 7) on the two-contig graph, where MakeGaps adds a gap and
FinalFiles rewrites the line files, and compares every file."""

import importlib
import os

import numpy as np
import pytest

from w2rap_contigger_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch.core import dna
from w2rap_contigger_tpu_torch.core.reads import ReadSet
from w2rap_contigger_tpu_torch.graph import build as gb
from w2rap_contigger_tpu_torch.graph.hbv import HyperBasevector
from w2rap_contigger_tpu_torch.ops import kmer_engine as ke
from w2rap_contigger_tpu_torch.paths import pather
from w2rap_contigger_tpu_torch.paths.read_paths import ReadPathVec

PACKAGES = ("w2rap_contigger_tpu", "w2rap_contigger_tpu_torch")
HBV_FIELDS = ("edge_bases", "edge_start", "to_left", "to_right", "inv")
PATH_FIELDS = ("offsets", "edges", "start")


# ---------------------------------------------------------------------------
# the graphs of the JAX package's tests
# ---------------------------------------------------------------------------


def mk_hbv(k, n_vertices, edges):
    """test_simplify_late_passes.py's mk_hbv: forward (left, right, seq)
    edges plus their mirrors, inv pairing edge i with i + len(edges)."""
    seqs = [np.asarray(s, dtype=np.uint8) for (_, _, s) in edges]
    all_seqs = seqs + [dna.revcomp_codes(s) for s in seqs]
    all_l = [l for (l, _, _) in edges] + [n_vertices + r for (_, r, _) in edges]
    all_r = [r for (_, r, _) in edges] + [n_vertices + l for (l, _, _) in edges]
    nf = len(edges)
    inv = np.concatenate([np.arange(nf) + nf, np.arange(nf)]).astype(np.int32)
    flat, start = HyperBasevector.from_edge_list(k, all_seqs)
    return HyperBasevector(k, flat, start, np.asarray(all_l, np.int32),
                           np.asarray(all_r, np.int32), inv, 2 * n_vertices)


def from_reads(seqs, quals, k, min_freq=1, min_qual=7):
    """count -> adjacencies -> unitigs -> HBV -> read paths, on the port's
    CPU route (the JAX tests' ke.count_kmers ... pather.path_reads)."""
    reads = ReadSet.from_sequences(seqs, quals)
    d, _ = ke.count_kmers_device(reads.bases, reads.lengths, reads.quals, k,
                                 min_qual=min_qual, min_freq=min_freq, device="cpu")
    gb.recompute_adjacencies(d)
    eb, es = gb.build_unitigs(d)
    hbv, fx, rx = gb.build_hbv_from_edges(eb, es, k)
    paths = pather.path_reads(reads, d, hbv, fx, rx, chunk_reads=1024)
    return hbv, paths, reads


def single_reads(genomes, rlen=100, stride=2):
    """Both strands of every rlen window at `stride` (test_pathfinder.py)."""
    seqs = []
    for g in genomes:
        for s in range(0, len(g) - rlen + 1, stride):
            seqs += [g[s : s + rlen], dna.revcomp_codes(g[s : s + rlen])]
    return seqs


def tamp_graph(shift):
    rng = np.random.default_rng(1234)
    x1 = rng.integers(0, 4, size=400).astype(np.uint8)
    if shift:  # test_tamp_shifted_branch
        x2 = x1[2:152].copy()
        plists, starts = [[0]], [0]
    else:  # test_tamp_folds_matching_branch
        x2 = x1[:150].copy()
        x2[100] = (x2[100] + 1) % 4
        plists, starts = [[0], [0], [2]], [10, 200, 5]  # 2 = inv[0]
    return mk_hbv(60, 3, [(0, 2, x1), (0, 1, x2)]), ReadPathVec.from_lists(plists, starts), None


def repeat_graph():
    """test_pullaparter_separates_canonical_repeat: l0/l1 - c - r0/r1,
    4 pairs on one phase, 3 on the other."""
    rng = np.random.default_rng(1234)
    k = 15
    c = rng.integers(0, 4, size=40).astype(np.uint8)

    def mk(n):
        return rng.integers(0, 4, size=n).astype(np.uint8)

    l0, l1 = (np.concatenate([mk(30), c[: k - 1]]) for _ in range(2))
    r0, r1 = (np.concatenate([c[-(k - 1) :], mk(30)]) for _ in range(2))
    hbv = mk_hbv(k, 6, [(0, 2, l0), (1, 2, l1), (2, 3, c), (3, 4, r0), (3, 5, r1)])
    inv = hbv.inv
    plists = []
    for n, (a, b) in ((4, (0, 3)), (3, (1, 4))):
        plists += [[a, 2, b], [int(inv[b]), int(inv[2]), int(inv[a])]] * n
    return hbv, ReadPathVec.from_lists(plists, [0] * len(plists)), None


def loop_graph():
    """test_pathfinder.py's loop_genome A R L R B, k=21."""
    rng = np.random.default_rng(1234)
    k = 21
    parts = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (1200, 3 * k, 300, 1200)]
    genome = np.concatenate([parts[0], parts[1], parts[2], parts[1], parts[3]])
    return from_reads(single_reads([genome]), None, k)


def two_context_graph():
    """A 40 bp repeat in two contexts, A R B and C R D (1 kb flanks),
    read by 100 bp reads that span it: one short edge between two long
    in-edges and two long out-edges, phased by the read paths."""
    rng = np.random.default_rng(0)
    A, B, C, D = (rng.integers(0, 4, size=1000).astype(np.uint8) for _ in range(4))
    R = rng.integers(0, 4, size=40).astype(np.uint8)
    return from_reads(single_reads([np.concatenate([A, R, B]), np.concatenate([C, R, D])]),
                      None, 21)


def unplaced_read_graph():
    """test_improve_paths_places_unplaced_read."""
    rng = np.random.default_rng(1234)
    es = rng.integers(0, 4, size=300).astype(np.uint8)
    reads = ReadSet.from_sequences([es[50:150]], [np.full(100, 30, np.uint8)])
    return mk_hbv(15, 2, [(0, 1, es)]), ReadPathVec.from_lists([[]], [0]), reads


def bubble_graph():
    """test_pop_bubbles_removes_error_branch: a SNP seen by 2 low-quality
    reads against 40x of the true haplotype, k=15."""
    rng = np.random.default_rng(1234)
    genome = rng.integers(0, 4, size=1500).astype(np.uint8)
    variant = genome.copy()
    variant[750] = (variant[750] + 1) % 4
    rlen = 80
    seqs = [genome[s : s + rlen] for s in range(0, 1500 - rlen, 2)]
    quals = [np.full(rlen, 38, np.uint8)] * len(seqs)
    seqs += [variant[s : s + rlen] for s in (720, 740)]
    quals += [np.full(rlen, 3, np.uint8)] * 2
    return from_reads(seqs, quals, 15, min_qual=2)


def two_contig_graph():
    """test_make_gaps_links_two_contigs: two 8 kb contigs, a 150 bp gap
    no read covers, pairs that span it; k=21, min_freq 2."""
    rng = np.random.default_rng(1234)
    genome = np.concatenate([rng.integers(0, 4, size=n).astype(np.uint8)
                             for n in (8000, 150, 8000)])
    rlen, insert, g0, g1 = 100, 400, 8000, 8150
    seqs = []
    for s in range(0, len(genome) - insert, 7):
        if any(not (x + rlen <= g0 or x >= g1) for x in (s, s + insert - rlen)):
            continue
        frag = genome[s : s + insert]
        seqs += [frag[:rlen], dna.revcomp_codes(frag[-rlen:])]
    return from_reads(seqs, [np.full(rlen, 38, np.uint8)] * len(seqs), 21, min_freq=2)


# ---------------------------------------------------------------------------
# one package's objects, and the cases
# ---------------------------------------------------------------------------


def as_package(pkg, hbv, paths, reads):
    """Fresh copies of the inputs as `pkg`'s own classes (PathFinder and
    PullAparter edit their graph in place)."""
    H = importlib.import_module(f"{pkg}.graph.hbv").HyperBasevector
    P = importlib.import_module(f"{pkg}.paths.read_paths").ReadPathVec
    R = importlib.import_module(f"{pkg}.core.reads").ReadSet
    h = H(hbv.k, *(getattr(hbv, f).copy() for f in HBV_FIELDS), hbv.n_vertices)
    p = P(*(getattr(paths, f).copy() for f in PATH_FIELDS))
    r = None if reads is None else R(reads.bases.copy(), reads.lengths.copy(),
                                     reads.quals.copy())
    return h, p, r


def run_tamp(m, h, p, r, out, shift):
    return m("graph.tamp").tamp(h, p, shift)


def run_pullaparter(m, h, p, r, out):
    pa = m("paths.pullaparter").PullAparter(h, p)
    n = pa.separate_all()
    return pa.hbv, pa.paths, n, pa.removed_read_paths


def run_unroll(m, h, p, r, out):
    pf = m("paths.pathfinder").PathFinder(h, p)
    n = pf.unroll_loops(800)
    return pf.hbv, pf.paths, n, pf.classify_forks()


def run_untangle(m, h, p, r, out):
    pf = m("paths.pathfinder").PathFinder(h, p)
    n = pf.untangle_complex_in_out_choices(700)
    h, p = m("graph.ops").squeeze(pf.hbv, pf.paths)
    return h, p, n, m("graph.branches")._truncate_nonwalks(h, p)


def run_improve(m, h, p, r, out):
    p2, n = m("paths.improve").improve_paths(h, p, r)
    return h, p2, n


def run_bubbles(m, h, p, r, out):
    return m("graph.bubbles").pop_bubbles(h, p, r)


def run_degloop(m, h, p, r, out):
    return m("graph.degloop").degloop(h, p, r, mode=1, min_dist=2.5)


def run_simplify(m, h, p, r, out):
    """The whole pass sequence, PathFinder included, then the contig
    outputs (lines, stats, coverage, frag dist, GFA)."""
    s6 = m("pipeline.step6_simplify")
    h, p = s6.simplify(h, p, r, run_pathfinder=True)
    lines, stats = s6.contig_outputs(h, p, out, prefix="a")
    return h, p, lines, stats


def run_make_gaps(m, h, p, r, out):
    lines = m("graph.lines").find_lines(h)
    return m("pipeline.step7_scaffold").make_gaps(h, p, lines, min_line=5000,
                                                   min_link_count=3)


def run_coverage_gfa(m, h, p, r, out):
    """compute_coverage, cn_integer_fraction and frag_dist on the
    two-contig graph; gfa_dump with its lines and with find_lines."""
    cov = m("pipeline.coverage")
    lines = m("graph.lines").find_lines(h)
    covs, base = cov.compute_coverage(h, p, lines)
    cov.frag_dist(h, p, f"{out}/a.fin.frags.dist")
    gfa = m("graph.gfa")
    gfa.gfa_dump(h, f"{out}/lines", lines=lines)
    gfa.gfa_dump(h, f"{out}/found", find_lines=True)
    return h, p, covs, base, cov.cn_integer_fraction(h, covs)


CASES = {
    # name: (graph, run, what the pass must change)
    "tamp_fold": (lambda: tamp_graph(False), lambda *a: run_tamp(*a, 0), "edges"),
    "tamp_shift": (lambda: tamp_graph(True), lambda *a: run_tamp(*a, 10), "edges"),
    "pullaparter": (repeat_graph, run_pullaparter, "edges"),
    "unroll_loops": (loop_graph, run_unroll, "edges"),
    "untangle": (two_context_graph, run_untangle, "edges"),
    "improve_paths": (unplaced_read_graph, run_improve, "paths"),
    "pop_bubbles": (bubble_graph, run_bubbles, "edges"),
    "degloop": (bubble_graph, run_degloop, "edges"),
    "simplify": (bubble_graph, run_simplify, "edges"),
    "make_gaps": (two_contig_graph, run_make_gaps, "edges"),
    "coverage_gfa": (two_contig_graph, run_coverage_gfa, "files"),
}


def same(a, b, what):
    """Exact equality of two results, through graphs, paths, numbers,
    arrays and containers of them."""
    if hasattr(a, "edge_bases"):
        assert (a.k, a.n_vertices) == (b.k, b.n_vertices), what
        for f in HBV_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"{what}.{f}")
    elif hasattr(a, "offsets"):
        for f in PATH_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"{what}.{f}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for key in a:
            same(a[key], b[key], f"{what}[{key}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert a == b or (a != a and b != b), what


def files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(f"{d}/{name}", "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_step6_module_matches_jax(case, tmp_path):
    graph, run, changes = CASES[case]
    hbv, paths, reads = graph()
    results = {}
    for pkg in PACKAGES:
        out = tmp_path / pkg
        out.mkdir()

        def m(name, pkg=pkg):
            return importlib.import_module(f"{pkg}.{name}")

        results[pkg] = (run(m, *as_package(pkg, hbv, paths, reads), str(out)),
                        files(str(out)))
    (want, want_files), (got, got_files) = (results[p] for p in PACKAGES)
    same(want, got, case)
    assert want_files.keys() == got_files.keys()
    for name in want_files:
        assert got_files[name] == want_files[name], name
    h2, p2 = got[0], got[1]
    if changes == "edges":
        assert h2.n_edges != hbv.n_edges, f"{case} changed no edge"
    elif changes == "paths":
        assert not np.array_equal(p2.edges, paths.edges), f"{case} changed no path"
    else:
        assert got_files and all(got_files.values())
    if case == "make_gaps":
        assert got[2] == 2 and int((h2.edge_len() == 0).sum()) == 2  # one gap, fw + rc


def test_step7_with_a_gap_matches_jax(tmp_path):
    """Both pipelines' step 7 on the two-contig graph as pe.contig: MakeGaps
    adds a gap, so pe_assembly.* are written and a.lines.fasta and stats
    rewritten; every file byte for byte."""
    hbv, paths, _ = two_contig_graph()
    dirs = {}
    for pkg in PACKAGES:
        d = dirs[pkg] = tmp_path / pkg
        d.mkdir()
        hbv.save(f"{d}/pe.contig.hbv.npz")
        paths.save(f"{d}/pe.contig.paths.npz")
    jax_run_pipeline(out_dir=str(dirs[PACKAGES[0]]), from_step=7, shard_devices=0)
    h2, _, d = cli.main(["-o", str(dirs[PACKAGES[1]]), "--from_step", "7", "--device", "cpu"])
    assert d is None and h2.n_edges == hbv.n_edges + 2
    want, got = files(str(dirs[PACKAGES[0]])), files(str(dirs[PACKAGES[1]]))
    assert sorted(got) == sorted(want)
    for name in ("pe_assembly.hbv.npz", "pe_assembly.paths.npz", "a.lines.fasta", "stats",
                 "pe_assembly_raw.gfa", "pe_assembly_lines.gfa"):
        assert name in got
    for name in want:
        if name.endswith(".npz"):
            za, zb = np.load(f"{dirs[PACKAGES[0]]}/{name}"), np.load(f"{dirs[PACKAGES[1]]}/{name}")
            assert sorted(za.files) == sorted(zb.files)
            for key in za.files:
                np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")
        else:
            assert got[name] == want[name], name
