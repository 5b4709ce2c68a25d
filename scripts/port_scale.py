"""The port's steps on one GPU at a genome size given on the command
line, once per option set: walls, the peak device memory of step 2's
count and of the whole run, the step split and the kernel launches.

    python3 scripts/port_scale.py --glen 16000000 --pairs 1920000 \
        --runs "-d 4 -m 4" "" --to_step 2 4 [--work DIR] [-K 260]

Synthesises reads with scripts/make_synth_fastq.py (--seed 42, PE250,
insert 500), then runs the port's CLI (--device cuda, W2RAP_TIMELOG=1,
--dump_perf) once per entry of --runs (extra CLI options, "" for none)
to the matching --to_step (one value for all runs, or one each).  A run
that runs out of device memory prints its error and the script goes on.
Each run prints its .perf line, its split and its peak device memory;
the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from w2rap_contigger_tpu_torch import device as tdev  # noqa: E402
from w2rap_contigger_tpu_torch.utils import sysinfo  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--glen", type=int, required=True)
    ap.add_argument("--pairs", type=int, required=True)
    ap.add_argument("-K", dest="large_k", default="260")
    ap.add_argument("--runs", nargs="+", default=[""])
    ap.add_argument("--to_step", nargs="+", type=int, default=[2])
    ap.add_argument("--work", default=None)
    args = ap.parse_args()
    steps = args.to_step * len(args.runs) if len(args.to_step) == 1 else args.to_step
    if len(steps) != len(args.runs):
        raise SystemExit("--to_step: one value, or one for each run")
    cs.phase_probe()
    cs.phase_build()
    os.environ["W2RAP_TIMELOG"] = "1"
    with tempfile.TemporaryDirectory(prefix="w2rap_scale_") as tmp:
        data = args.work or tmp
        cs.say("synth", genome=args.glen, pairs=args.pairs,
               seconds=f"{cs.synth(data, args.glen, args.pairs):.1f}")
        for i, (extra, to_step) in enumerate(zip(args.runs, steps)):
            opts = ["-K", args.large_k, "--dump_perf", *shlex.split(extra)]
            opts = [o.replace("{out}", f"{data}/run{i}") for o in opts]
            sysinfo.timelog_reset()
            tdev.reset_launches()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            try:
                with cs.CountPeak() as count:
                    cs.run_cli(data, f"{data}/run{i}", cs.DEV, opts, to_step=to_step)
            except torch.OutOfMemoryError as e:
                cs.say("scale_run", options=repr(extra), to_step=to_step, oom=True,
                       seconds=f"{time.time() - t0:.2f}", error=repr(str(e)[:200]))
                continue
            torch.cuda.synchronize()
            wall = time.time() - t0
            with open(f"{data}/run{i}/pe.perf") as f:
                perf = " | ".join(x.strip() for x in f)
            cs.say("scale_run", options=repr(extra), to_step=to_step, wall_s=f"{wall:.2f}",
                   count_s=f"{count.seconds:.3f}", count_max_memory_allocated=count.peak,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=json.dumps({n: v for n, v in tdev.LAUNCHES.items() if v}))
            cs.say("scale_split", options=repr(extra), **cs._split())
            cs.say("scale_perf", options=repr(extra), perf=repr(perf))


if __name__ == "__main__":
    main()
