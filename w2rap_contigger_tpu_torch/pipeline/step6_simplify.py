"""Step 6 — graph simplification + lines + contig outputs.

Reference: Simplify (src/paths/long/large/Simplify.cc:22-244) with the
driver's parameters (w2rap-contigger.cc:477-494: MAX_SUPP_DEL=0,
MIN_RATIO2=8, MAX_DEL2=200, DEGLOOP_MIN_DIST=2.5 ...), then FindLines +
GFADump (w2rap-contigger.cc:496-558).

All reference passes are implemented: unsupported-edge deletion,
RemoveSmallComponents3, Tamp (early + shift-10), RemoveHangs,
AnalyzeBranches, PopBubbles, DeleteFunkyPathPairs, PullAparter,
PathFinder (opt-in), ImprovePaths, ExtendPath2, Degloop,
UnwindThreeEdgePlasmids, and the final tiny-stuff cleanup.

Host numpy, as in the JAX package.  Under W2RAP_TIMELOG=1 the phases
are the sections step6.reroute, step6.passes, step6.pullaparter,
step6.pathfinder (opt-in), step6.improve, step6.ext_final and step6.tail.
"""

from __future__ import annotations

import numpy as np

from ..graph import gfa, lines as lines_mod, ops

from ..config import DEFAULT as _H
from ..utils.sysinfo import timelog

MIN_MULT = _H.MIN_MULT  # Simplify.cc:44


def remove_unsupported_edges(hbv, paths, max_supp_del: int = 0):
    """Simplify.cc:41-95: at 2-way branches, delete the branch whose
    path support is <= MAX_SUPP_DEL when the other has >= 10x support.
    Two symmetric passes (From side, To side) with direction-aware
    support counts."""
    E = hbv.n_edges
    inv = hbv.inv
    flat = paths.edges
    lens = paths.path_len()
    rid = np.repeat(np.arange(paths.n_reads), lens)
    local = (
        np.arange(len(flat)) - np.repeat(paths.offsets[:-1], lens)
        if len(flat)
        else np.zeros(0, np.int64)
    )
    plen_of = np.repeat(lens, lens) if len(flat) else np.zeros(0, np.int64)

    dels = []
    fo, fe, to, te = hbv.vertex_csr()

    # pass 1: From side; support counts entries at j>=1, + inv for j<last
    support = np.zeros(E, dtype=np.int64)
    if len(flat):
        np.add.at(support, flat[local >= 1], 1)
        np.add.at(support, inv[flat[local < plen_of - 1]], 1)
    for v in range(hbv.n_vertices):
        es = fe[fo[v] : fo[v + 1]]
        if len(es) != 2:
            continue
        e1, e2 = int(es[0]), int(es[1])
        if support[e1] > support[e2]:
            e1, e2 = e2, e1
        if support[e1] <= max_supp_del and support[e2] >= MIN_MULT * max(
            1, support[e1]
        ):
            dels.append(e1)

    # pass 2: To side; support counts entries at j<last, + inv for j>=1
    support = np.zeros(E, dtype=np.int64)
    if len(flat):
        np.add.at(support, flat[local < plen_of - 1], 1)
        np.add.at(support, inv[flat[local >= 1]], 1)
    for v in range(hbv.n_vertices):
        es = te[to[v] : to[v + 1]]
        if len(es) != 2:
            continue
        e1, e2 = int(es[0]), int(es[1])
        if support[e1] > support[e2]:
            e1, e2 = e2, e1
        if support[e1] <= max_supp_del and support[e2] >= MIN_MULT * max(
            1, support[e1]
        ):
            dels.append(e1)

    if dels:
        hbv, paths = ops.delete_edges(hbv, paths, np.array(dels))
        hbv, paths = ops.squeeze(hbv, paths)
    return hbv, paths


def simplify(hbv, paths, reads=None, max_supp_del: int = 0, max_del2: int = 200,
             run_pathfinder: bool = False, tamp_early: bool = True,
             improve: bool = True, ext_final_pass: bool = True,
             dump_pf: str | None = None):
    """The full Simplify pass sequence (Simplify.cc:22-244), with the
    driver's defaults (w2rap-contigger.cc:477-494): TAMP_EARLY,
    IMPROVE_PATHS, EXT_FINAL(mode 1, min_gain 20), DEGLOOP(1, 2.5),
    UNWIND3, FINAL_TINY all on."""

    def cleanup(h, p):
        h, p = ops.squeeze(h, p)
        return h, p

    from ..graph import branches, bubbles, reroute
    from ..graph.tamp import tamp as tamp_pass

    if reads is not None:
        with timelog("step6.reroute"):
            paths, _ = reroute.reroute_paths(hbv, paths, reads)
            paths, _ = reroute.delete_funky_path_pairs(hbv, paths, reads)

    with timelog("step6.passes"):
        hbv, paths = remove_unsupported_edges(hbv, paths, max_supp_del)
        hbv, paths = ops.remove_small_components(hbv, paths)
        hbv, paths = cleanup(hbv, paths)
        if tamp_early:
            hbv, paths = tamp_pass(hbv, paths, 0)
        hbv, paths = ops.remove_hangs(hbv, paths, 100)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = branches.analyze_branches(hbv, paths, min_ratio2=8)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = ops.remove_hangs(hbv, paths, max_del2)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = ops.remove_small_components(hbv, paths)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = bubbles.pop_bubbles(hbv, paths, reads)
        hbv, paths = cleanup(hbv, paths)
        if reads is not None:
            paths, _ = reroute.delete_funky_path_pairs(hbv, paths, reads)
        hbv, paths = tamp_pass(hbv, paths, 10)
        hbv, paths = ops.remove_hangs(hbv, paths, 700)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = ops.remove_small_components(hbv, paths)
        hbv, paths = cleanup(hbv, paths)

    # Pull apart canonical repeats (Simplify.cc:141-151)
    from ..paths.pullaparter import PullAparter

    with timelog("step6.pullaparter"):
        pa = PullAparter(hbv, paths)
        pa.separate_all()
        hbv, paths = pa.hbv, pa.paths

    if run_pathfinder:
        from ..paths.pathfinder import PathFinder

        # --dump_pf: PathFinder-stage checkpoints for --dev_run_test
        # replay (Simplify.cc:157-191: pf_start / pf_unrolled_loops /
        # pf_end graph+paths dumps)
        with timelog("step6.pathfinder"):
            if dump_pf:
                hbv.save(f"{dump_pf}/pf_start.hbv.npz")
                paths.save(f"{dump_pf}/pf_start.paths.npz")
            pf = PathFinder(hbv, paths)
            pf.unroll_loops(800)
            hbv, paths = cleanup(pf.hbv, pf.paths)
            if dump_pf:
                hbv.save(f"{dump_pf}/pf_unrolled_loops.hbv.npz")
                paths.save(f"{dump_pf}/pf_unrolled_loops.paths.npz")
            pf = PathFinder(hbv, paths)
            pf.untangle_complex_in_out_choices(700)
            hbv, paths = cleanup(pf.hbv, pf.paths)
            from ..graph.branches import _truncate_nonwalks

            paths = _truncate_nonwalks(hbv, paths)
            if dump_pf:
                hbv.save(f"{dump_pf}/pf_end.hbv.npz")
                paths.save(f"{dump_pf}/pf_end.paths.npz")

    if improve and reads is not None:
        from ..paths.improve import improve_paths

        with timelog("step6.improve"):
            paths, _ = improve_paths(hbv, paths, reads)
    if ext_final_pass and reads is not None:
        from ..paths.extend import ext_final

        with timelog("step6.ext_final"):
            paths, _ = ext_final(hbv, paths, reads, min_gain=20, mode=1)

    from ..graph import degloop as degloop_mod
    from ..graph import plasmids
    from ..graph import validate

    with timelog("step6.tail"):
        hbv, paths = degloop_mod.degloop(hbv, paths, reads, mode=1, min_dist=2.5)
        hbv, paths = ops.remove_hangs(hbv, paths, 700)
        hbv, paths = cleanup(hbv, paths)
        hbv, paths = plasmids.unwind_three_edge_plasmids(hbv, paths)
        hbv, paths = ops.remove_small_components(hbv, paths, remove_small_cycles=True)
        hbv, paths = cleanup(hbv, paths)
        validate.test_involution(hbv)
        validate.validate_paths(hbv, paths)
    return hbv, paths


def contig_outputs(hbv, paths, out_dir: str, prefix: str = "a"):
    """FindLines + SortLines + DumpLineFiles + coverage/CN + FragDist +
    stats + GFADump (w2rap-contigger.cc:496-558, FinalFiles.cc:22)."""
    from . import coverage as cov_mod

    lines = lines_mod.find_lines(hbv, max_cell_paths=50, max_depth=10)
    lines = lines_mod.sort_lines(hbv, lines)
    lines_mod.dump_line_files(hbv, lines, out_dir, prefix, paths=paths)
    stats = lines_mod.write_stats(hbv, lines, out_dir)
    covs, base_cov = cov_mod.compute_coverage(hbv, paths, lines)
    stats["cn_frac_good"] = round(cov_mod.cn_integer_fraction(hbv, covs), 2)
    with open(f"{out_dir}/stats", "a") as f:
        f.write(f"cn_frac_good: {stats['cn_frac_good']}\n")
    cov_mod.frag_dist(hbv, paths, f"{out_dir}/{prefix}.fin.frags.dist")
    gfa.gfa_dump(hbv, f"{out_dir}/{prefix}_contigs", lines=lines)
    return lines, stats
