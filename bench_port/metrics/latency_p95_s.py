"""latency_p95_s (s), layer CLI, moves throughput: the 95th percentile
of one family's wall (host clock around ``cli.prrn_main``) over every
family of the traced window."""

import numpy as np

LAYER = "CLI"


def read(run):
    if not run.walls:
        return None
    return float(np.percentile(run.walls, 95))
