"""throughput (res/s), end to end, host clock: the input residues of
every family the window completed over the time from the window's start
to the end of its last family."""

LAYER = "CLI"


def read(run):
    if not run.walls:
        return None
    return sum(run.residues) / run.window_s
