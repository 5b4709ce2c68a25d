"""Device trace of the port's step 3 (RepathInMemory) on one NVIDIA GPU.

    python3 scripts/port_trace.py --out DIR [-K 260] [--sort radix lax]

DIR holds the small_K checkpoints of a step-2 run (pe.small_K.hbv.npz,
pe.small_K.paths.npz), for example a `chip_smoke.py --work W` run's
W/ecoli/k260_radix.  For each sort back end, step 3 runs once to warm up
(kernel build, allocator), then once under torch.profiler (CPU + CUDA
activities) with W2RAP_TIMELOG=1.  Printed per back end: the step-3 wall
(host clock, ends in a device synchronise), the TIMELOG span split, the
device busy time as the union of the intervals of every device event
(kernels, copies, sets) in the trace, the idle share 1 - busy / window
(window: from the first to the last event of the profiled run on either
side), and the device time by kernel name, largest first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from w2rap_contigger_tpu_torch import __main__ as cli  # noqa: E402
from w2rap_contigger_tpu_torch.utils import sysinfo  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run_step3(src: str, dst: str, k: int):
    os.makedirs(dst, exist_ok=True)
    for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
        shutil.copy(f"{src}/{name}", dst)
    t0 = time.time()
    cli.main(["-o", dst, "--from_step", "3", "--to_step", "3", "-K", str(k),
              "--device", "cuda"])
    torch.cuda.synchronize()
    return time.time() - t0


def busy_and_window(trace_path: str):
    """(busy s, window s, {kernel name: (s, launches)}) from a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans, by_name = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        spans.append((a, b))
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b))
            t, c = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (t + e["dur"] / 1e6, c + 1)
    busy, end = 0.0, None
    for a, b in sorted(dev):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return busy / 1e6, window / 1e6, by_name


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory with small_K checkpoints")
    ap.add_argument("-K", type=int, default=260)
    ap.add_argument("--sort", nargs="+", default=["radix", "lax"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_trace.py needs an NVIDIA GPU")
    print(torch.cuda.get_device_name(0), flush=True)
    os.environ["W2RAP_TIMELOG"] = "1"
    with tempfile.TemporaryDirectory(prefix="w2rap_trace_") as tmp:
        for sort in args.sort:
            os.environ["W2RAP_SORT"] = sort
            warm = run_step3(args.out, f"{tmp}/warm_{sort}", args.K)
            sysinfo.timelog_reset()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                wall = run_step3(args.out, f"{tmp}/prof_{sort}", args.K)
            trace = f"{tmp}/trace_{sort}.json"
            prof.export_chrome_trace(trace)
            busy, window, by_name = busy_and_window(trace)
            split = {}
            for line in sysinfo.timelog_report().splitlines():
                _, name, secs, _ = [x.strip() for x in line.split(",")]
                split[name] = secs
            print(f"[trace] sort={sort} K={args.K} warm_wall_s={warm:.3f} "
                  f"profiled_wall_s={wall:.3f} window_s={window:.3f} "
                  f"device_busy_s={busy:.3f} idle_share={1 - busy / window:.4f} "
                  f"device_events={sum(c for _, c in by_name.values())}", flush=True)
            print(f"[trace_split] sort={sort} " + " ".join(f"{k}={v}" for k, v in split.items()),
                  flush=True)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
            for name, (secs, calls) in top:
                print(f"[trace_kernel] sort={sort} s={secs:.4f} launches={calls} "
                      f"name={name[:110]!r}", flush=True)


if __name__ == "__main__":
    main()
