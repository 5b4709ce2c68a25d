"""Seconds a pass spends in the pathing's device lookups (the port's span
step2.pathing.lookup, inside step2.pathing), averaged over the passes of
the traced window."""

SOURCE = "program_span"
LAYER = "pathing"
MOVES = "graph_reads_per_s"
UNIT = "s"
SPAN = "step2.pathing.lookup"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
