"""The trace reduction: busy time is the union of device intervals, the
window spans every event, kernels sum by name, and idle gaps go to the
host operation that covers at least half of them."""

from benchmark import trace


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_summary_of_a_small_trace():
    events = [
        _ev("cpu_op", "aten::sort", 0, 150_000),      # covers the 0-0.1 s gap
        _ev("kernel", "kmerize_kernel<4>", 100_000, 200_000),
        _ev("kernel", "other", 250_000, 150_000),      # overlaps the first
        _ev("gpu_memcpy", "Memcpy HtoD", 900_000, 100_000),
        _ev("cpu_op", "aten::to", 400_000, 400_000),   # covers 0.8 of the 0.4-0.9 s gap
        _ev("kernel", "kmerize_kernel<4>", 1_500_000, 100_000),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 0},
    ]
    s = trace.Summary(events)
    assert abs(s.window_s - 1.6) < 1e-9
    assert abs(s.busy_s - (0.3 + 0.1 + 0.1)) < 1e-9
    secs, launches = s.kernel_s("kmerize_kernel")
    assert abs(secs - 0.3) < 1e-9 and launches == 2
    assert s.kernel_s("absent") == (0.0, 0)
    gaps = dict(s.idle_gaps)
    assert abs(gaps["host: aten::to"] - 0.5) < 1e-9          # 0.4-0.9 s
    assert abs(gaps["host: aten::sort"] - 0.1) < 1e-9        # 0-0.1 s
    assert abs(gaps["host, no torch operation"] - 0.5) < 1e-9  # 1.0-1.5 s
    assert s.device_ops[0][0] == "kmerize_kernel<4>"
