"""Seconds a pass spends packing and uploading all of its reads before the
first K1 sweep, when the count runs in hash ranges (-d/-m; the port's
span step2.count.range.pack), averaged over the passes of the traced
window.  None where the count took the unbatched path."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.range.pack"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
