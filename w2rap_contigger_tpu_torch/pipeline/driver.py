"""Pipeline driver of the port: steps 1-7 with the JAX package's
checkpoints.

Counterpart of w2rap_contigger_tpu/pipeline/driver.py:52-243.  Step 1
is host `extract_reads`; steps 2 and 3 run on `device` through this
package, or sharded over a mesh of devices; step 4 (Clean200x) is host numpy, as in the JAX package; step 5
(AssembleGaps2 + AddNewStuff + PartnersToEnds) runs its blobs on the
host with pre-correction and AddNewStuff's graph on `device`; steps 6
(Simplify + contig outputs) and 7 (MakeGaps + FinalFiles) are host
numpy, as in the JAX package.  Outputs have the JAX package's names and
formats: frag_reads_orig.npz, small_K.freqs, <p>.small_K.hbv.npz /
.paths.npz (step 2), <p>.large_K.hbv.npz / .paths.npz (step 3),
<p>.large_K.clean.hbv.npz / .paths.npz (step 4), <p>.large_K.final.hbv.npz
/ .paths.npz (step 5), <p>.contig.* and the a.* contig files (step 6),
<p>_assembly.* and the <p>_assembly GFA (step 7) and <p>.perf.
"""

from __future__ import annotations

import os
import time

from ..core.io_fastq import extract_reads
from ..core.reads import ReadSet
from ..device import ASSEMBLY, LAUNCHES, RANGED, resolve_device, timed
from ..graph import gfa, lines as lines_mod
from ..graph.hbv import HyperBasevector
from ..parallel import mesh as pmesh
from ..paths.pathfinder import PathFinder
from ..paths.read_paths import ReadPathVec
from ..utils import sysinfo
from . import (step2_small_k, step3_repath, step4_clean, step5_gaps, step6_simplify,
               step7_scaffold)


class PerfLog:
    """`TIME, <section>, <wall s>, <cpu s>` lines (checkpoint_perf_time,
    w2rap-contigger.cc:32-46)."""

    def __init__(self, path=None):
        self.path = path
        self.t0 = time.time()
        self.c0 = time.process_time()
        if path:
            with open(path, "w") as f:
                f.write("")

    def checkpoint(self, section: str):
        t1, c1 = time.time(), time.process_time()
        line = f"TIME, {section}, {t1 - self.t0:.2f}, {c1 - self.c0:.2f}"
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        self.t0, self.c0 = t1, c1
        return line


def run_pipeline(
    out_dir: str,
    read_spec: str | None = None,
    reads: ReadSet | None = None,
    prefix: str = "pe",
    large_k: int = 200,
    from_step: int = 1,
    to_step: int = 7,
    min_freq: int = 4,
    min_qual: int = 7,
    min_size: int = 0,
    dump_all: bool = False,
    dump_perf: bool = False,
    chunk_reads: int = 65536,
    path_finder: bool = False,
    threads: int = 4,
    max_mem_gb: int = 10000,
    disk_batches: int = 0,
    tmp_dir: str | None = None,
    pair_sample: int = 200,
    extend_paths: bool = False,
    dump_pf: bool = False,
    fill_join: bool = False,
    shard_devices: int = -1,
    mesh=None,
    device="cuda",
):
    """Run steps from_step..to_step (1..7) on `device`; returns (hbv,
    paths, dict): the graph and paths of the last step that ran, and the
    last kmer dictionary counted by steps 2-3 (Nones where no step made
    them).

    Steps 2 and 3 run sharded over `mesh` (a parallel.mesh.Mesh; logical
    shards may repeat a device), else over parallel.mesh.auto_mesh
    (shard_devices: -1 every visible device of `device`'s type, 0 off, N
    at most N; W2RAP_SHARD overrides; one device leaves the run
    unsharded), as the JAX package's run_pipeline does (:81-89).  Outputs are the same
    either way.  Steps 4-7 take no mesh."""
    dev = resolve_device(device)
    if mesh is None:
        asked, visible = pmesh.shard_request(shard_devices), pmesh.visible_devices(dev)
        mesh = pmesh.auto_mesh(shard_devices, dev)
        if asked > visible:
            print(f"--shard {asked}: {visible} {dev.type} device(s) visible")
    if mesh is not None:
        print(f"sharding over {mesh.size} devices")
    dev23 = mesh.devices[0] if mesh is not None else dev
    os.makedirs(out_dir, exist_ok=True)
    perf = PerfLog(f"{out_dir}/{prefix}.perf" if dump_perf else None)
    p = f"{out_dir}/{prefix}"
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(threads))
    sysinfo.set_max_memory(int(max_mem_gb) << 30)

    hbv = paths = d = None

    def get_reads():
        # steps 2, 4 and 5 read the reads; a later --from_step loads them
        nonlocal reads
        if reads is None:
            reads = ReadSet.load(f"{out_dir}/frag_reads_orig.npz")
        return reads

    if from_step <= 1 <= to_step:
        if reads is None:
            if not read_spec:
                raise ValueError("step 1 needs read files (-r)")
            reads = extract_reads(read_spec)
        reads.save(f"{out_dir}/frag_reads_orig.npz")
        print(f"peak mem usage = {sysinfo.peak_mem_usage_gb_string()} GB")
        perf.checkpoint("ReadLoad")

    if from_step <= 2 <= to_step:
        hbv, paths, d = step2_small_k.build_read_q_graph(
            get_reads(),
            min_qual=min_qual,
            min_freq=min_freq,
            workdir=out_dir,
            chunk_reads=chunk_reads,
            disk_batches=disk_batches,
            tmp_dir=tmp_dir,
            max_mem_gb=max_mem_gb,
            do_fill_gaps=fill_join,
            do_join_overlaps=fill_join,
            mesh=mesh,
            device=dev23,
        )
        if dump_all or to_step == 2:
            hbv.save(f"{p}.small_K.hbv.npz")
            paths.save(f"{p}.small_K.paths.npz")
        perf.checkpoint("SmallKGraph")
    elif from_step == 3:
        hbv = HyperBasevector.load(f"{p}.small_K.hbv.npz")
        paths = ReadPathVec.load(f"{p}.small_K.paths.npz")

    if from_step <= 3 <= to_step:
        hbv, paths, d = step3_repath.repath(
            hbv, paths, large_k, extend_paths=extend_paths, device=dev23, mesh=mesh
        )
        if dump_all or to_step == 3:
            hbv.save(f"{p}.large_K.hbv.npz")
            paths.save(f"{p}.large_K.paths.npz")
        perf.checkpoint("RepathInMemory")
    elif from_step == 4:
        hbv = HyperBasevector.load(f"{p}.large_K.hbv.npz")
        paths = ReadPathVec.load(f"{p}.large_K.paths.npz")

    if from_step <= 4 <= to_step:
        with sysinfo.timelog("step4.clean200x"):
            hbv, paths = step4_clean.clean200x(hbv, paths, get_reads(), min_size=min_size)
        if dump_all or to_step == 4:
            hbv.save(f"{p}.large_K.clean.hbv.npz")
            paths.save(f"{p}.large_K.clean.paths.npz")
        perf.checkpoint("Clean200x")
    elif from_step == 5:
        hbv = HyperBasevector.load(f"{p}.large_K.clean.hbv.npz")
        paths = ReadPathVec.load(f"{p}.large_K.clean.paths.npz")

    if from_step <= 5 <= to_step:
        # AssembleGaps2 + AddNewStuff + PartnersToEnds
        # (w2rap-contigger.cc:424-459)
        from ..paths.partners import partners_to_ends

        new_stuff = step5_gaps.assemble_gaps2(
            hbv, paths, get_reads(), pair_sample=pair_sample,
            threads=threads, device=dev,
        )
        if new_stuff:
            with timed("step5.add_new_stuff", dev):
                hbv, paths = step5_gaps.add_new_stuff(
                    hbv, paths, get_reads(), new_stuff, chunk_reads=chunk_reads,
                    device=dev,
                )
        with timed("step5.partners", dev):
            paths, _ = partners_to_ends(hbv, paths, get_reads())
        if dump_all or to_step == 5:
            hbv.save(f"{p}.large_K.final.hbv.npz")
            paths.save(f"{p}.large_K.final.paths.npz")
        perf.checkpoint("AssembleGaps")
    elif from_step == 6:
        hbv = HyperBasevector.load(f"{p}.large_K.final.hbv.npz")
        paths = ReadPathVec.load(f"{p}.large_K.final.paths.npz")

    if from_step <= 6 <= to_step:
        # Simplify + lines + contig outputs (w2rap-contigger.cc:477-558)
        hbv, paths = step6_simplify.simplify(
            hbv, paths, get_reads(), run_pathfinder=path_finder,
            dump_pf=out_dir if dump_pf else None,
        )
        with sysinfo.timelog("step6.outputs"):
            step6_simplify.contig_outputs(hbv, paths, out_dir, prefix="a")
        hbv.save(f"{p}.contig.hbv.npz")
        paths.save(f"{p}.contig.paths.npz")
        with sysinfo.timelog("step6.classify"):
            PathFinder(hbv, paths).classify_forks(log=True)
        perf.checkpoint("Simplify")
    elif from_step == 7:
        hbv = HyperBasevector.load(f"{p}.contig.hbv.npz")
        paths = ReadPathVec.load(f"{p}.contig.paths.npz")

    if from_step <= 7 <= to_step:
        # PE scaffolding, then FinalFiles (FinalFiles.cc:22): re-find
        # lines and re-emit the outputs from the scaffolded graph
        with sysinfo.timelog("step7.make_gaps"):
            lines7 = lines_mod.find_lines(hbv)
            hbv, paths, n_gaps = step7_scaffold.make_gaps(
                hbv, paths, lines7, min_line=5000, min_link_count=3
            )
        with sysinfo.timelog("step7.final_files"):
            if n_gaps:
                hbv.save(f"{p}_assembly.hbv.npz")
                paths.save(f"{p}_assembly.paths.npz")
                lines_f = lines_mod.find_lines(hbv)
                lines_f = lines_mod.sort_lines(hbv, lines_f)
                lines_mod.dump_line_files(hbv, lines_f, out_dir, "a", paths=paths)
                lines_mod.write_stats(hbv, lines_f, out_dir)
            gfa.gfa_dump(hbv, f"{out_dir}/{prefix}_assembly", find_lines=True)
        perf.checkpoint("MakeGaps+FinalFiles")

    if sysinfo.timelog_enabled():
        rep = sysinfo.timelog_report()
        if rep:
            print(rep)
        # the unitig chains of the whole run, and those the host finished
        print("UNITIGS, " + ", ".join(f"{name} {n}" for name, n in ASSEMBLY.items()))
        # the step-2 counts that ran in hash ranges (-d, -m)
        print("RANGED, " + ", ".join(f"{name} {n}" for name, n in RANGED.items()))
        # the hand-written kernels' launches of the whole run (pack: K0)
        print("LAUNCHES, " + ", ".join(f"{name} {n}" for name, n in LAUNCHES.items()))
    return hbv, paths, d
