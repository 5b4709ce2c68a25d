"""Seconds a pass spends pathing the reads (the port's span step2.pathing:
the host pack, the lookups on the card and the host decode), averaged
over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "pathing"
MOVES = "graph_reads_per_s"
UNIT = "s"
SPAN = "step2.pathing"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
