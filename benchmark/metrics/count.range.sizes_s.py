"""Seconds a pass spends in the range path's sizing sweep: one K1 pass
over the uploaded chunks that counts the valid rows of each of the 256
finest hash ranges (the port's span step2.count.range.sizes), averaged
over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.range.sizes"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
