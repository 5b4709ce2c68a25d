"""K2's share of its roofline, in %: the least time of a pass's K2 launch
(benchmark/roofline.py: the sorted stream of valid windows read, every
row written, at the H100's 3.35 TB/s) over its device time, summed over
the traced window from the profiler's kernel events named
collapse_kernel.  No such event: no reading."""

from benchmark import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "count_kmers_per_s"
UNIT = "%"
KERNEL = "collapse_kernel"


def read(run):
    secs, launches = run["trace"].kernel_s(KERNEL)
    if not launches or secs <= 0:
        return None
    sh = run["shapes"]
    return 100.0 * run["passes"] * roofline.k2_bound_s(sh["k2_rows"], sh["k"]) / secs
