"""The card's idle share of the traced window of the graph cells, in %:
1 - (union of kernel, copy and set intervals) / (first to last event of
the trace)."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "graph_reads_per_s"
UNIT = "%"


def read(run):
    t = run["trace"]
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
