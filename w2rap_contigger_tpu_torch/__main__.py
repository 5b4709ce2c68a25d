"""CLI of the port — the flags of w2rap_contigger_tpu/__main__.py:23-60
plus --device.

Usage:
  python -m w2rap_contigger_tpu_torch -r r1.fastq,r2.fastq -o out_dir \\
      --to_step 2 [--device cuda|cpu] [-p prefix] [--dump_perf] ...

Only steps 1 and 2 are ported; --to_step above 2 raises
NotImplementedError.  --device cuda (the default) needs a card and never
falls back to the CPU; --device cpu runs the plain PyTorch versions of
the kernels and exists for the tests.
"""

from __future__ import annotations

import argparse

from .shared import ALLOWED_K


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
                    help="multi-device sharding: -1 auto, 0 off, N devices")
    ap.add_argument("--dev_run_test", default="",
                    choices=["", "pathfinder", "pathfinder2"],
                    help="replay step 6 from --dump_pf checkpoints")
    ap.add_argument("--heuristics", default="",
                    help="NAME=value,... overrides (long_heuristics analogue)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of step 2 (cpu: plain PyTorch, for tests)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns step 2's (hbv, paths, dict)."""
    args = parse_args(argv)
    if args.large_k not in ALLOWED_K:
        raise SystemExit(
            f"-K {args.large_k}: not an allowed K; pick from "
            + ",".join(str(x) for x in ALLOWED_K)
        )
    if args.dev_run_test:
        raise NotImplementedError(
            "--dev_run_test (step 6 replay) is not ported yet; see ROADMAP.md"
        )
    if args.shard > 1:
        raise NotImplementedError(
            "multi-device sharding is not ported yet; see ROADMAP.md"
        )
    if args.heuristics:
        import dataclasses

        from .shared import config as _cfg

        heur = _cfg.parse_heuristics(args.heuristics)
        for f in dataclasses.fields(heur):
            setattr(_cfg.DEFAULT, f.name, getattr(heur, f.name))

    from .pipeline.driver import run_pipeline

    return run_pipeline(
        out_dir=args.out_dir,
        read_spec=args.read_files,
        prefix=args.prefix,
        from_step=args.from_step,
        to_step=args.to_step,
        min_freq=args.min_freq,
        min_qual=args.min_qual,
        dump_all=args.dump_all,
        dump_perf=args.dump_perf,
        threads=args.threads,
        max_mem_gb=args.max_mem,
        disk_batches=args.disk_batches,
        tmp_dir=args.tmp_dir,
        fill_join=args.fill_join,
        device=args.device,
    )


if __name__ == "__main__":
    main()
