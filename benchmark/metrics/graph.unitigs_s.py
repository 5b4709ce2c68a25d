"""Seconds a pass spends building the unitigs (the port's span step2.unitigs:
the links and list ranking on the card, their download, and the host
chain assembly), averaged over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "graph"
MOVES = "graph_reads_per_s"
UNIT = "s"
SPAN = "step2.unitigs"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
