"""CLI of the port — the flags of w2rap_contigger_tpu/__main__.py:23-60
plus --device.

Usage:
  python -m w2rap_contigger_tpu_torch -r r1.fastq,r2.fastq -o out_dir \\
      [-K 200|260|...] [-s min_size] [--device cuda|cpu] ...
  python -m w2rap_contigger_tpu_torch -o out_dir --dev_run_test pathfinder

All seven steps run; the default --to_step 7 writes a.lines.fasta,
stats and the GFA files.  --device cuda (the default) needs a card and
never falls back to the CPU; --device cpu runs the plain PyTorch
versions of the kernels and exists for the tests.  W2RAP_SORT=lax|
radix|pallas picks the counting sort of steps 2 and 3, as in the JAX
package.  --shard N (or W2RAP_SHARD=N) shards steps 2 and 3 over the
visible cards, clamped to a power of two as the JAX package's auto_mesh
does; with one card (or --device cpu) the run is unsharded.
"""

from __future__ import annotations

import argparse

ALLOWED_K = [
    60, 64, 72, 80, 84, 88, 96, 100, 108, 116, 128, 136, 144, 152, 160,
    168, 172, 180, 188, 192, 196, 200, 208, 216, 224, 232, 240, 260,
    280, 300, 320, 368, 400, 440, 460, 500, 544, 640,
]  # reference allowed_k (w2rap-contigger.cc:60-62)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="w2rap-contigger-tpu-torch")
    ap.add_argument("-r", "--read_files", help="r1.fastq,r2.fastq (.gz ok)")
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("-p", "--prefix", default="pe")
    ap.add_argument("-K", "--large_k", type=int, default=200)
    ap.add_argument("--from_step", type=int, default=1)
    ap.add_argument("--to_step", type=int, default=7)
    ap.add_argument("--min_freq", type=int, default=4)
    ap.add_argument("--min_qual", type=int, default=7)
    ap.add_argument("-s", "--min_size", type=int, default=0)
    ap.add_argument("--path_finder", action="store_true")
    ap.add_argument("--dump_all", action="store_true")
    ap.add_argument("--dump_perf", action="store_true")
    ap.add_argument("-t", "--threads", type=int, default=4,
                    help="host-side thread cap (SetThreads analogue)")
    ap.add_argument("-m", "--max_mem", type=int, default=10000,
                    help="soft memory ceiling in GB (SetMaxMemory analogue)")
    ap.add_argument("-d", "--disk_batches", type=int, default=0,
                    help="hash-range counting batches (0 = in-memory)")
    ap.add_argument("--tmp_dir", default=None,
                    help="spill dir for -d range batches")
    ap.add_argument("--pair_sample", type=int, default=200,
                    help="max pairs per gap-assembly blob")
    ap.add_argument("--extend_paths", action="store_true",
                    help="extend places through solo edges in step 3")
    ap.add_argument("--dump_pf", action="store_true",
                    help="dump PathFinder-stage checkpoints in step 6")
    ap.add_argument("--fill_join", action="store_true",
                    help="step-2 fillGaps+joinOverlaps repair passes")
    ap.add_argument("--shard", type=int, default=-1,
                    help="shard steps 2-3 over the visible devices of --device: "
                         "-1 all, 0 off, N at most N (a power of two; W2RAP_SHARD "
                         "overrides; -d, -m and --tmp_dir are then ignored)")
    ap.add_argument("--dev_run_test", default="",
                    choices=["", "pathfinder", "pathfinder2"],
                    help="replay step 6 from --dump_pf checkpoints")
    ap.add_argument("--heuristics", default="",
                    help="NAME=value,... overrides (long_heuristics analogue)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the kernels of steps 2, 3 and 5; steps 4, 6 and 7 "
                         "are host numpy (cpu: plain PyTorch, for tests)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the last step's (hbv, paths, dict), or the
    replayed step 6's (hbv, paths, None) under --dev_run_test."""
    args = parse_args(argv)
    if args.large_k not in ALLOWED_K:
        raise SystemExit(
            f"-K {args.large_k}: not an allowed K; pick from "
            + ",".join(str(x) for x in ALLOWED_K)
        )
    if args.heuristics:
        import dataclasses

        from . import config as _cfg

        heur = _cfg.parse_heuristics(args.heuristics)
        for f in dataclasses.fields(heur):
            setattr(_cfg.DEFAULT, f.name, getattr(heur, f.name))

    if args.dev_run_test:
        return _dev_run_test(args)

    from .pipeline.driver import run_pipeline

    return run_pipeline(
        out_dir=args.out_dir,
        read_spec=args.read_files,
        prefix=args.prefix,
        large_k=args.large_k,
        from_step=args.from_step,
        to_step=args.to_step,
        min_freq=args.min_freq,
        min_qual=args.min_qual,
        min_size=args.min_size,
        dump_all=args.dump_all,
        dump_perf=args.dump_perf,
        path_finder=args.path_finder,
        threads=args.threads,
        max_mem_gb=args.max_mem,
        disk_batches=args.disk_batches,
        tmp_dir=args.tmp_dir,
        pair_sample=args.pair_sample,
        extend_paths=args.extend_paths,
        dump_pf=args.dump_pf,
        fill_join=args.fill_join,
        shard_devices=args.shard,
        device=args.device,
    )


def _dev_run_test(args):
    """--dev_run_test pathfinder|pathfinder2: replay step 6 from the
    --dump_pf checkpoints through the end of step 6, mirroring the
    reference dev harness (w2rap-contigger.cc:190-297).

    pathfinder: load pf_start.*, run unroll_loops(800) + cleanup, dump
    pf_after_loops.*, then continue.  pathfinder2: start directly from
    pf_after_loops.*.  Both then run untangle + the post-PathFinder
    Simplify tail and re-emit the contig outputs.  Host numpy, like
    step 6; --device is checked as for a run (cuda without a card
    raises).
    """
    from .core.reads import ReadSet
    from .device import resolve_device
    from .graph import degloop as degloop_mod, plasmids
    from .graph import ops as gops
    from .graph.hbv import HyperBasevector
    from .paths.extend import ext_final
    from .paths.improve import improve_paths
    from .paths.pathfinder import PathFinder
    from .paths.read_paths import ReadPathVec
    from .pipeline import step6_simplify

    resolve_device(args.device)
    out = args.out_dir
    print("=== w2rap contigger tpu: development test run ===")
    if args.dev_run_test == "pathfinder":
        hbv = HyperBasevector.load(f"{out}/pf_start.hbv.npz")
        paths = ReadPathVec.load(f"{out}/pf_start.paths.npz")
        pf = PathFinder(hbv, paths)
        pf.unroll_loops(800)
        hbv, paths = gops.squeeze(pf.hbv, pf.paths)
        hbv.save(f"{out}/pf_after_loops.hbv.npz")
        paths.save(f"{out}/pf_after_loops.paths.npz")
    else:
        hbv = HyperBasevector.load(f"{out}/pf_after_loops.hbv.npz")
        paths = ReadPathVec.load(f"{out}/pf_after_loops.paths.npz")

    pf = PathFinder(hbv, paths)
    pf.untangle_complex_in_out_choices(700)
    hbv, paths = gops.squeeze(pf.hbv, pf.paths)

    reads = ReadSet.load(f"{out}/frag_reads_orig.npz")
    paths, _ = improve_paths(hbv, paths, reads)
    paths, next_ = ext_final(hbv, paths, reads, min_gain=20, mode=1)
    print(f"{next_} paths extended")
    hbv, paths = degloop_mod.degloop(hbv, paths, reads, mode=1, min_dist=2.5)
    hbv, paths = gops.remove_hangs(hbv, paths, 700)
    hbv, paths = gops.squeeze(hbv, paths)
    hbv, paths = plasmids.unwind_three_edge_plasmids(hbv, paths)
    hbv, paths = gops.remove_small_components(hbv, paths, remove_small_cycles=True)
    hbv, paths = gops.squeeze(hbv, paths)
    step6_simplify.contig_outputs(hbv, paths, out, prefix="a")
    hbv.save(f"{out}/{args.prefix}.contig.hbv.npz")
    paths.save(f"{out}/{args.prefix}.contig.paths.npz")
    print("Dumping contig graph and paths...\n   DONE!")
    return hbv, paths, None


if __name__ == "__main__":
    main()
