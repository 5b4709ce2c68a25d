"""Seconds a pass spends in the count's sort (the port's span
step2.count.sort: under the default lax back end, stable torch.sort
passes over the stream's int64 keys), averaged over the passes of the
traced window."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.sort"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
