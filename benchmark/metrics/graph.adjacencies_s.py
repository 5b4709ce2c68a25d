"""Seconds a pass spends pruning the dictionary's contexts (the port's span
step2.adjacencies: eight batched dictionary searches a k-mer on the card),
averaged over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "graph"
MOVES = "graph_reads_per_s"
UNIT = "s"
SPAN = "step2.adjacencies"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
