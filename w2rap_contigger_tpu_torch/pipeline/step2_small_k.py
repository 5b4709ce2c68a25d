"""Step 2 — the small-k (k=60) de Bruijn graph + read paths, on one device.

Counterpart of w2rap_contigger_tpu/pipeline/step2_small_k.py:18-118
(buildReadQGraph, src/paths/long/BuildReadQGraph.cc:1253, called with
minQual=7, minFreq=4, K=60) without `mesh` and without the fill/join
repair passes, which are not ported yet.
"""

from __future__ import annotations

from .. import SMALL_K
from ..device import resolve_device, timed
from ..graph import build as gb
from ..ops import kmer_engine as ke
from ..paths import pather
from ..shared import extend


def build_read_q_graph(
    reads,
    min_qual: int = 7,
    min_freq: int = 4,
    k: int = SMALL_K,
    workdir: str | None = None,
    chunk_reads: int = 65536,
    disk_batches: int = 0,
    tmp_dir: str | None = None,
    max_mem_gb: int = 10000,
    do_fill_gaps: bool = False,
    do_join_overlaps: bool = False,
    mesh=None,
    device="cuda",
):
    """Returns (hbv, paths, dict) — graph, read paths, kmer dictionary.

    Writes `small_K.freqs` into workdir when given.  Every device stage
    (count, adjacencies, unitig links, pathing lookups) runs on
    `device`; the chain assembly, HBV build, path decode and extension
    are host numpy.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device step 2 (mesh) is not ported yet; see ROADMAP.md"
        )
    if do_fill_gaps or do_join_overlaps:
        raise NotImplementedError(
            "fill_join (graph/gapfill.py) is not ported yet; see ROADMAP.md"
        )
    dev = resolve_device(device)

    with timed("step2.count", dev):
        d, hist = ke.count_kmers_batched(
            reads.bases, reads.lengths, reads.quals, k,
            min_qual=min_qual, min_freq=min_freq, chunk_reads=chunk_reads,
            disk_batches=disk_batches, tmp_dir=tmp_dir,
            max_mem_gb=max_mem_gb, device=dev,
        )
    if workdir:
        with open(f"{workdir}/small_K.freqs", "w") as f:
            for i in range(1, 101):
                f.write(f"{i}, {hist[i]}\n")

    with timed("step2.adjacencies", dev):
        gb.recompute_adjacencies(d)
    with timed("step2.unitigs", dev):
        edge_bases, edge_start = gb.build_unitigs(d)
    with timed("step2.hbv", dev):
        hbv, fwd_xlat, rev_xlat = gb.build_hbv_from_edges(
            edge_bases, edge_start, k
        )
    with timed("step2.pathing", dev):
        paths = pather.path_reads(
            reads, d, hbv, fwd_xlat, rev_xlat, chunk_reads=chunk_reads
        )
    with timed("step2.extend", dev):
        paths = extend.extend_paths(reads, paths, hbv)
    return hbv, paths, d
