"""Seconds a pass spends in the ranges' K1 sweeps: one per range over all
the uploaded chunks, each keeping only its range's valid rows in its
stream (the port's span step2.count.range.kmerize, summed over the
ranges), averaged over the passes of the traced window."""

SOURCE = "program_span"
LAYER = "counting"
MOVES = "count_kmers_per_s"
UNIT = "s"
SPAN = "step2.count.range.kmerize"


def read(run):
    if SPAN not in run["spans"] or not run["passes"]:
        return None
    return run["spans"][SPAN] / run["passes"]
