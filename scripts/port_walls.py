"""Spread of the port's step walls and spans over repeated runs on one GPU.

    python3 scripts/port_walls.py --data DIR [--runs 3] [--to_step 3]
        [-K 260] [--sort lax radix pallas] [--parent CHECKOUT]

DIR holds reads_R1.fastq and reads_R2.fastq (scripts/make_synth_fastq.py).
Every run is one process, `python -m w2rap_contigger_tpu_torch -r ... -o
OUT --to_step N -K K --device cuda --dump_perf` with W2RAP_TIMELOG=1 and
W2RAP_SORT set, so each run builds its state from nothing as a user's run
does (the kernels' build is cached on disk after the first).  With
--parent, a second checkout of the port runs the same commands, in the
order parent, this, this, parent, ... so both see the same card.

Printed per run: the `.perf` walls (ReadLoad, SmallKGraph, RepathInMemory,
Clean200x, host clock, seconds), the sort spans and the step-4 span; then, per checkout and back end,
the min and max of each over the runs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("step2.count", "step2.count.sort", "step3.count", "step3.count.sort",
         "step4.clean200x")


def one_run(checkout: str, data: str, out: str, args, sort: str) -> dict:
    env = dict(os.environ, W2RAP_TIMELOG="1", W2RAP_SORT=sort)
    cmd = [sys.executable, "-m", "w2rap_contigger_tpu_torch",
           "-r", f"{data}/reads_R1.fastq,{data}/reads_R2.fastq", "-o", out,
           "--to_step", str(args.to_step), "--device", "cuda", "--dump_perf"]
    if args.to_step >= 3:
        cmd += ["-K", str(args.K)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        sys.stderr.write(res.stderr[-4000:])
        raise SystemExit(f"run failed in {checkout} (rc {res.returncode})")
    got = {}
    with open(f"{out}/pe.perf") as f:
        for line in f:
            parts = [x.strip() for x in line.split(",")]
            if len(parts) >= 3 and parts[0] == "TIME":
                got[parts[1]] = float(parts[2])
    for line in res.stdout.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 4 and parts[0] == "TIMELOG" and parts[1] in SPANS:
            got[parts[1]] = float(parts[2].rstrip("s"))
    return got


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="directory with reads_R{1,2}.fastq")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--to_step", type=int, default=3)
    ap.add_argument("-K", type=int, default=260)
    ap.add_argument("--sort", nargs="+", default=["lax", "radix"])
    ap.add_argument("--parent", default=None, help="another checkout of the port")
    args = ap.parse_args()
    order = [("this", REPO)]
    if args.parent:
        order = [("parent", args.parent), ("this", REPO)]
    results: dict[tuple[str, str], list[dict]] = {}
    with tempfile.TemporaryDirectory(prefix="w2rap_walls_") as tmp:
        for r in range(args.runs):
            seq = order if r % 2 == 0 else order[::-1]
            for sort in args.sort:
                for name, checkout in seq:
                    out = f"{tmp}/{name}_{sort}_{r}"
                    got = one_run(checkout, args.data, out, args, sort)
                    results.setdefault((name, sort), []).append(got)
                    print(f"[walls_run] checkout={name} sort={sort} run={r} to_step="
                          f"{args.to_step} " + " ".join(f"{k}={v}" for k, v in got.items()),
                          flush=True)
    for (name, sort), runs in results.items():
        keys = [k for k in runs[0] if all(k in x for x in runs)]
        print(f"[walls_range] checkout={name} sort={sort} runs={len(runs)} " + " ".join(
            f"{k}={min(x[k] for x in runs)}..{max(x[k] for x in runs)}" for k in keys),
            flush=True)


if __name__ == "__main__":
    main()
