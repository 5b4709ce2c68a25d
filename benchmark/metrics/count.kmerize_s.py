"""Seconds a pass spends in the count's first stage: the host pack, the
upload and K1 (the port's span step2.count.kmerize, which opens after the
previous span closed and synchronises the card as it closes), averaged
over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.kmerize"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
