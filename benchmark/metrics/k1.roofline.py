"""K1's share of its roofline, in %: the least time of a pass's K1
launches (benchmark/roofline.py: W + 1 planes written, packed rows and
usable lengths read, at the H100's 3.35 TB/s) over their device time,
summed over the traced window from the profiler's kernel events named
kmerize_kernel.  No such event: no reading."""

from benchmark import roofline

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "count_kmers_per_s"
UNIT = "%"
KERNEL = "kmerize_kernel"


def read(run):
    secs, launches = run["trace"].kernel_s(KERNEL)
    if not launches or secs <= 0:
        return None
    sh = run["shapes"]
    return 100.0 * run["passes"] * roofline.k1_bound_s(sh["reads"], sh["read_len"], sh["k"]) / secs
