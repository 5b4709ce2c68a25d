"""Step 2 — the small-k (k=60) de Bruijn graph + read paths, on one device.

Counterpart of w2rap_contigger_tpu/pipeline/step2_small_k.py:18-118
(buildReadQGraph, src/paths/long/BuildReadQGraph.cc:1253, called with
minQual=7, minFreq=4, K=60), with or without a mesh.
"""

from __future__ import annotations

from .. import SMALL_K
from ..device import resolve_device, timed
from ..graph import build as gb
from ..graph import gapfill
from ..ops import kmer_engine as ke
from ..paths import pather
from ..paths import extend

# fillGaps / joinOverlaps: min_freq2 = max(2, int(MIN_FREQ2_FRACT * min_freq
# + .5)) (BuildReadQGraph.cc:1286); fillGaps takes gaps of any size, the
# driver's max_gap_size 0 (w2rap-contigger.cc:338)
MIN_FREQ2_FRACT = 0.75
FILL_MAX_GAP_SIZE = 0

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

    disk_batches > 1, or a counting working set above max_mem_gb, counts
    in hash ranges, each spilled to tmp_dir when given
    (kmer_engine.count_kmers_batched).  do_fill_gaps / do_join_overlaps
    run the graph repair passes of graph/gapfill.py.

    mesh (a parallel.mesh.Mesh): the count, adjacencies, unitig links and
    read pathing run sharded over its devices (JAX :55-115), bit for bit
    the unsharded run; `device` is then its first device.  disk_batches,
    max_mem_gb and tmp_dir are ignored, as the JAX mesh branch ignores
    them; the fill/join passes run unsharded.
    """
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)

    with timed("step2.count", dev):
        if mesh is not None:
            d, hist = ke.count_kmers_sharded(
                reads.bases, reads.lengths, reads.quals, k, mesh,
                min_qual=min_qual, min_freq=min_freq, chunk_reads=chunk_reads,
            )
        else:
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
        gb.recompute_adjacencies(d, mesh=mesh)
    with timed("step2.unitigs", dev):
        edge_bases, edge_start = gb.build_unitigs(d, mesh=mesh)
    min_freq2 = max(2, int(MIN_FREQ2_FRACT * min_freq + 0.5))
    if do_fill_gaps:
        with timed("step2.fill_gaps", dev):
            d, edge_bases, edge_start = gapfill.fill_gaps(
                reads, d, edge_bases, edge_start,
                FILL_MAX_GAP_SIZE, min_freq2, chunk_reads,
            )
    if do_join_overlaps:
        with timed("step2.join_overlaps", dev):
            d, edge_bases, edge_start = gapfill.join_overlaps(
                reads, d, edge_bases, edge_start,
                k // 2, min_freq2, chunk_reads,
            )
    with timed("step2.hbv", dev):
        hbv, fwd_xlat, rev_xlat = gb.build_hbv_from_edges(
            edge_bases, edge_start, k
        )
    with timed("step2.pathing", dev):
        paths = pather.path_reads(
            reads, d, hbv, fwd_xlat, rev_xlat, chunk_reads=chunk_reads, mesh=mesh
        )
    with timed("step2.extend", dev):
        paths = extend.extend_paths(reads, paths, hbv)
    return hbv, paths, d
