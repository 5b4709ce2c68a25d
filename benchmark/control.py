"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload ecoli.count --seeds 11 12 13 ... [--out FILE]

For each seed, in one process: the reads are made as a run makes them,
the program runs one pass of the cell's entry (a first pass builds the
kernels), and its output is judged against the plain reference; then the
control (the entry's `control`: the reference with one guarantee broken,
put in the program's place) is judged the same way.  Prints one JSON
line a seed: {"seed", "program": {check: value}, "control": {check:
value}}, and appends it to --out when given.  The benchmark's own runs do
not run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds: list, device: str = "cuda", config: dict | None = None):
    """Yield each seed's readings of the program and of the control."""
    import torch

    from benchmark import data, entries, run

    _, _, conf, mix = run.spec_of(workload)
    cfg = config if config is not None else run.load_json(conf["file"])
    os.environ["W2RAP_SORT"] = cfg["assembly"]["sort"]
    dev = torch.device(device)
    for seed in seeds:
        reads = data.make_reads(cfg, seed, dev)
        entry = entries.ENTRIES[mix["entry"]](cfg, reads, dev)
        out = entry.run_pass()
        entry.record(out)
        kept = entry.keep(out)
        del out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = entry.reference()
        program, _ = entry.judge(kept, ref)
        del kept
        control, _ = entry.judge(entry.control(ref), ref)
        yield {"seed": seed, "program": program, "control": control,
               "limits": mix["checks"]}
        del ref, entry, reads
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for rec in readings(args.workload, args.seeds):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
