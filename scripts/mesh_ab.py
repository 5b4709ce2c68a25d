"""Step 2's and step 3's counts over D logical shards of one card, and
unsharded, in turns between this checkout and another (a parent
unpacked with git archive into a gitignored directory).

    python3 scripts/mesh_ab.py --parent DIR [--ckpt DIR] [--shards 4]
        [--rounds 1] [--reps 4]

The input is a checkpoint directory of the port's CLI (`--dump_all`:
frag_reads_orig.npz and pe.small_K.{hbv,paths}.npz); --ckpt names one
(made there when it holds none), or else one is made in a new temporary
directory (under TMPDIR) and removed at the end.  It is made from
scripts/make_synth_fastq.py's E. coli scale (4.6 Mbp, 550k PE250 pairs,
seed 42) with this checkout's CLI to step 2; both checkouts read it.
Each run is a process of its own, in the order parent, change, change,
parent a round, so the two checkouts share the card's state.  A run
loads the reads and step 3's place sequences (K=260) and builds step
2's graph once, then times `reps` times each count as the pipeline calls
it (step 2's sharded count or count_kmers_batched, step 3's
count_kmers_flat) and step 2's read pathing (path_reads: the lookups on
the device, the decode on the host) on the host clock around
synchronised work; the first of the reps is the warm-up.  Prints
one JSON line a rep (the seconds of the counts and of the pathing,
their `W2RAP_TIMELOG` spans, the host waits where the checkout counts
them, the peak device memory of each) and, last, the medians of the
warm reps by checkout and mode.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
os.environ["W2RAP_TIMELOG"] = "1"
import torch
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.core.reads import ReadSet
from w2rap_contigger_tpu_torch.graph import build as gb
from w2rap_contigger_tpu_torch.graph.hbv import HyperBasevector
from w2rap_contigger_tpu_torch.ops import kmer_engine as ke
from w2rap_contigger_tpu_torch.parallel import mesh as tmesh
from w2rap_contigger_tpu_torch.paths import pather
from w2rap_contigger_tpu_torch.paths.read_paths import ReadPathVec
from w2rap_contigger_tpu_torch.pipeline import step3_repath as s3
from w2rap_contigger_tpu_torch.utils import sysinfo

ck, shards, K, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh = tmesh.make_mesh(["cuda"] * shards) if shards > 1 else None
reads = ReadSet.load(f"{ck}/frag_reads_orig.npz")
hbv = HyperBasevector.load(f"{ck}/pe.small_K.hbv.npz")
paths = ReadPathVec.load(f"{ck}/pe.small_K.paths.npz")
_, _, places = s3._places(hbv, paths, K, False)
flat, seg, _, _ = s3._place_sequences(hbv, places, K)


def step2():
    if mesh is not None:
        return ke.count_kmers_sharded(reads.bases, reads.lengths, reads.quals, 60, mesh,
                                      min_qual=7, min_freq=4, chunk_reads=65536)
    return ke.count_kmers_batched(reads.bases, reads.lengths, reads.quals, 60, min_qual=7,
                                  min_freq=4, chunk_reads=65536, device="cuda")


def step3():
    return ke.count_kmers_flat(flat, seg, K, min_freq=1, device="cuda", span="step3.count",
                               mesh=mesh)


graph = []


def step2_pathing():
    if not graph:  # step 2's graph, made once from the first count's dictionary
        d = step2()[0]
        gb.recompute_adjacencies(d, mesh=mesh)
        graph.append((d, *gb.build_hbv_from_edges(*gb.build_unitigs(d, mesh=mesh), 60)))
    d, hbv2, fx, rx = graph[0]
    return pather.path_reads(reads, d, hbv2, fx, rx, chunk_reads=65536, mesh=mesh)


step2_pathing()
for rep in range(reps):
    sysinfo.timelog_reset()
    out = {"rep": rep}
    for name, fn in (("step2.count", step2), ("step3.count", step3),
                     ("step2.pathing", step2_pathing)):
        waits = getattr(tdev, "HOST_WAITS", None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        out[name + ".peak"] = torch.cuda.max_memory_allocated()
        if waits is not None:
            out[name + ".host_waits"] = tdev.HOST_WAITS - waits
    spans = {}
    for line in sysinfo.timelog_report().splitlines():
        _, name, secs, _ = [x.strip() for x in line.split(",")]
        spans[name] = float(secs.rstrip("s"))
    out["spans"] = spans
    print(json.dumps(out), flush=True)
"""


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def checkpoints(ck: str) -> None:
    """Step 2's checkpoints at E. coli scale in ck, made with this
    checkout's CLI when ck holds none."""
    if os.path.exists(f"{ck}/pe.small_K.paths.npz"):
        return
    data = f"{ck}/reads"
    subprocess.run([sys.executable, f"{REPO}/scripts/make_synth_fastq.py", data,
                    "--glen", "4600000", "--pairs", "550000", "--rlen", "250",
                    "--insert", "500", "--seed", "42"], check=True, capture_output=True)
    subprocess.run([sys.executable, "-m", "w2rap_contigger_tpu_torch",
                    "-r", f"{data}/reads_R1.fastq,{data}/reads_R2.fastq", "-o", ck,
                    "--to_step", "2", "--dump_all", "--shard", "0"],
                   cwd=REPO, check=True, capture_output=True)


def run(checkout: str, ck: str, shards: int, K: int, reps: int) -> list[dict]:
    res = subprocess.run([sys.executable, "-c", RUNNER, ck, str(shards), str(K), str(reps)],
                         cwd=checkout, capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"{checkout} ({shards} shards) failed:\n{res.stderr[-4000:]}")
    return [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the other checkout")
    ap.add_argument("--ckpt", help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("-K", type=int, default=260)
    args = ap.parse_args()
    if args.ckpt is None:
        args.ckpt = tempfile.mkdtemp(prefix="mesh_ab_")
        try:
            compare(args)
        finally:
            shutil.rmtree(args.ckpt, ignore_errors=True)
    else:
        compare(args)


def compare(args):
    checkpoints(args.ckpt)
    print(json.dumps({"card": card()}), flush=True)
    warm = {}
    for r in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            checkout = os.path.abspath(args.parent) if label == "parent" else REPO
            for shards in (args.shards, 1):
                mode = f"{shards}_shards" if shards > 1 else "unsharded"
                for got in run(checkout, args.ckpt, shards, args.K, args.reps):
                    print(json.dumps({"round": r, "checkout": label, "mode": mode, **got}),
                          flush=True)
                    if got["rep"]:
                        warm.setdefault(f"{label}/{mode}", []).append(got)
    print(json.dumps({"medians": {
        key: {name: statistics.median(g[name] for g in runs)
              for name in ("step2.count", "step3.count", "step2.pathing",
                           "step2.count.peak", "step3.count.peak")}
        | {"warm_reps": len(runs)}
        for key, runs in sorted(warm.items())}}), flush=True)


if __name__ == "__main__":
    main()
