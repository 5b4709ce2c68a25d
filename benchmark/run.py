"""Run one cell of the port's benchmark once; print one JSON result line.

    python3 benchmark/run.py --workload ecoli.count --seed 7 --seconds 10 --trace 0

(or `python3 -m benchmark.run ...`), from the root of a checkout that holds
BENCHMARK.json, benchmark/ and w2rap_contigger_tpu_torch/.

The cell names a configuration (benchmark/configs/<config>.json: the
deployment's genome, reads and assembler settings) and a traffic mix
(benchmark/mixes/<traffic>.json: the entry of benchmark/entries.py it
drives, the end-to-end rate its work is reported under, and the limits of
its checks).  Set-up makes the reads from --seed on the card, then runs
the mix's warm passes, which build the kernels on a checkout's first run.
The window is a closed loop of whole passes, started while fewer than
--seconds have passed; rates are the work of all passes over the time
from the first pass's start to the last one's end.

--trace 0 reports the cell's end-to-end metrics; --trace 1 runs the same
window under torch.profiler with the port's span log on (W2RAP_TIMELOG=1)
and reports the cell's per-layer metrics (benchmark/metrics/<name>.py),
with the device's busy seconds, the traced window and a breakdown.

After the window the peak memory is read, the program's state is freed,
and the entry judges the passes' outputs against the plain reference
(benchmark/reference/).  Each number compared is printed with its limit as
the last lines of standard error and under "checks", the result's last
key.  The run exits 1 and prints no result when no CUDA card (or fewer
than the cell asks for) is visible, or when jax, jaxlib, flax or the JAX
package has been imported by the end of the run.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "w2rap_contigger_tpu")
CACHE = os.path.join(ROOT, "benchmark", ".cache")  # fixed, inside the checkout
GIB = float(1 << 30)


class RunError(Exception):
    """A run that cannot report a result."""


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def spec_of(workload: str):
    """(BENCHMARK.json, the cell, its configuration entry, its mix)."""
    spec = load_json("BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    mix = load_json("benchmark", "mixes", f"{cell['traffic']}.json")
    return spec, cell, conf, mix


def metrics_of(entries: list, cell: str) -> list:
    """The metrics of a BENCHMARK.json list that this cell reports."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def reader(entry: dict):
    """benchmark/metrics/<name>.py, checked against its BENCHMARK.json entry."""
    path = os.path.join(ROOT, "benchmark", "metrics", f"{entry['name']}.py")
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{entry['name']}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    for key in ("source", "layer", "moves", "unit"):
        if getattr(mod, key.upper()) != entry[key]:
            raise RunError(f"{path}: {key} {getattr(mod, key.upper())!r} but "
                           f"BENCHMARK.json says {entry[key]!r}")
    return mod


def card() -> dict:
    """The first card's name and power limit (nvidia-smi), for the record."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        line = ""
    return {"nvidia_smi": line or None}


class Window:
    """The measured closed loop: per-pass peaks and the passes' time."""

    def __init__(self, entry, dev, seconds: float):
        import torch

        self.torch, self.entry, self.dev, self.seconds = torch, entry, dev, seconds
        self.passes, self.peak, self.elapsed, self.last = 0, 0, 0.0, None
        self.pass_s: list[float] = []

    def _peak_read(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.dev))

    def _peak_reset(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def run(self):
        t0 = t = time.perf_counter()
        while t - t0 < self.seconds:
            self.last = None  # the previous pass's output is freed first
            self._peak_reset()
            self.last = self.entry.run_pass()
            self.peak = max(self.peak, self._peak_read())
            self.entry.record(self.last)
            self.passes += 1
            t, t_pass = time.perf_counter(), t
            self.pass_s.append(t - t_pass)
        self.elapsed = t - t0


def run(argv=None, device: str | None = None, config: dict | None = None) -> dict:
    """One run of a cell: the result object.  device and config replace
    the card and the cell's configuration (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec, cell, conf, mix = spec_of(args.workload)
    cfg = config if config is not None else load_json(conf["file"])

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA card: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{args.workload} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} visible")
        device = "cuda"
    dev = torch.device(device)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["W2RAP_SORT"] = cfg["assembly"]["sort"]
    os.environ["W2RAP_TIMELOG"] = "1" if args.trace else "0"
    torch.set_num_threads(min(4, torch.get_num_threads()))  # few host threads: steadier runs

    from benchmark import data, entries

    reads = data.make_reads(cfg, args.seed, dev)
    entry = entries.ENTRIES[mix["entry"]](cfg, reads, dev)
    for _ in range(int(mix["warm_passes"])):
        entry.run_pass()
    setup_s = time.time() - T_START
    peak_setup = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    window = Window(entry, dev, args.seconds)
    summary = None
    if args.trace:
        from benchmark import trace
        from w2rap_contigger_tpu_torch.utils import sysinfo

        sysinfo.timelog_reset()
        _, summary = trace.profile(window.run)
        spans = {}
        for line in sysinfo.timelog_report().splitlines():
            _, name, secs, _ = (x.strip() for x in line.split(","))
            spans[name] = float(secs.rstrip("s"))
    else:
        window.run()
    memory_peak = max(peak_setup, window.peak)

    kept = entry.keep(window.last)
    window.last = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.reference()
    checks, failed = entry.judge(kept, ref)
    reference_s = time.perf_counter() - t_ref
    limits = mix["checks"]
    correct = all(checks[name] <= limits[name] for name in limits)

    metrics = {}
    if args.trace:
        ctx = {"passes": window.passes, "spans": spans, "trace": summary,
               "shapes": entry.shapes(ref)}
        for m in metrics_of(spec["per_layer"], args.workload):
            value = reader(m).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {mix["rate_metric"]: entry.work * window.passes / window.elapsed,
                  "peak_dev_gib": window.peak / GIB, "setup_s": setup_s}
        for m in metrics_of(spec["end_to_end"], args.workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    dev_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": memory_peak}
    if dev.type == "cuda":
        dev_rec.update(card())
    if summary is not None:
        dev_rec.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": correct, "attempted": window.passes, "failed": failed,
              "metrics": metrics, "device": dev_rec}
    result["window"] = {"passes": window.passes, "seconds": window.elapsed,
                        "pass_s": window.pass_s, "reference_s": reference_s,
                        "reference": entry.notes(ref)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {"value": checks[name], "limit": limits[name]} for name in limits}
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    try:
        result = run(argv)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {', '.join(bad)}", file=sys.stderr, flush=True)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
