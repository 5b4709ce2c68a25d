"""Reduction of a torch.profiler trace of the measured window.

Device busy time is the union of the intervals of every device event
(kernels, copies, sets); the window runs from the first to the last event
of the trace on either side, and the idle share is 1 - busy / window.
Kernel time is summed by name.  Each idle gap between device intervals is
put down to the host operation that overlaps it most (the innermost on a
tie) when that covers at least half of it, else to host work that no
torch operation covers (numpy, the port's C++ leaves, Python).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
COVERS = 0.5  # a gap goes to a host operation that covers this share of it
LONG_S = 0.01  # host operations longer than this are checked against every gap
TOP = 10


class Summary:
    """busy_s, window_s, kernels {name: [seconds, launches]}, and the
    breakdown's device_ops and idle_gaps ([name, seconds], at most TOP)."""

    def __init__(self, events: list):
        dev, host, first, last = [], [], None, None
        self.kernels: dict[str, list] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) / 1e6
            b = a + float(e["dur"]) / 1e6
            first = a if first is None else min(first, a)
            last = b if last is None else max(last, b)
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                dev.append((a, b))
                k = self.kernels.setdefault(e["name"], [0.0, 0])
                k[0] += b - a
                k[1] += 1
            elif cat in HOST_CATS:
                host.append((a, b, e["name"]))
        self.window_s = (last - first) if first is not None else 0.0
        merged = []
        for a, b in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged)
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        if merged:
            gaps += [(first, merged[0][0]), (merged[-1][1], last)]
        self.device_ops = [[n, v[0]] for n, v in
                           sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]]
        self.idle_gaps = _label_gaps(gaps, host)

    def kernel_s(self, fragment: str) -> tuple[float, int]:
        """(seconds, launches) of the device events whose name holds fragment."""
        s, n = 0.0, 0
        for name, (secs, launches) in self.kernels.items():
            if fragment in name:
                s += secs
                n += launches
        return s, n


def _label_gaps(gaps, host) -> list:
    """Idle seconds by what the host was doing, largest first.  An
    operation that covers half of a gap contains the gap's midpoint, so
    only those are looked at: the short ones that start at most LONG_S
    before it, and the long ones."""
    gaps = [(a, b) for a, b in gaps if b > a]
    if not gaps:
        return []
    host = sorted(host)
    starts = np.array([h[0] for h in host])
    ends = np.array([h[1] for h in host])
    long_ops = np.flatnonzero(ends - starts > LONG_S)
    by_label: dict[str, float] = {}
    for a, b in gaps:
        m = (a + b) / 2
        lo, hi = np.searchsorted(starts, [m - LONG_S, m], side="right")
        cand = np.concatenate([np.arange(lo, hi), long_ops[starts[long_ops] <= m]])
        cand = cand[ends[cand] >= m]
        label = "host, no torch operation"
        if cand.size:
            ov = np.minimum(ends[cand], b) - np.maximum(starts[cand], a)
            j = cand[np.lexsort((starts[cand], ov))[-1]]  # most overlap, then innermost
            if ov.max() >= COVERS * (b - a):
                label = f"host: {host[j][2]}"
        by_label[label] = by_label.get(label, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]


def profile(fn):
    """Run fn() under torch.profiler (CPU and CUDA activities): (fn's
    result, Summary).  The trace is written to a temporary directory and
    removed once read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Summary(events)
