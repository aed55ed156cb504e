"""copy_kb (KB/family), layer ops, moves throughput: the bytes the
program's wrappers copy between the host and the card, both ways (its
counters ``copy.h2d_bytes``: the group DP's stacked inputs and the
distance pass's operands; ``copy.d2h_bytes``: the group DP's plan
counts, scores and moves and the distance pass's scores), in thousands,
over the families of the traced window.  None where the program counts
no copy."""

LAYER = "ops"


def read(run):
    nbytes = sum(c["copy.h2d_bytes"] + c["copy.d2h_bytes"]
                 for c in run.launches)
    if not nbytes or not run.walls:
        return None
    return nbytes / 1e3 / len(run.walls)
