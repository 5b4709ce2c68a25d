"""Seconds a pass spends in the ranges' sorts (the port's span
step2.count.range.sort, summed over the ranges: under the default lax back
end, stable torch.sort passes over each range's int64 keys), averaged
over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.range.sort"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
