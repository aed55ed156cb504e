"""refine_ms (ms/family), layer refine, moves throughput: the refine
span's host time (started and ended by ``torch.cuda.synchronize()``)
summed over the traced window, over the families it completed."""

LAYER = "refine"


def read(run):
    total = sum(s for layer, s in run.spans if layer == LAYER)
    return 1e3 * total / len(run.walls) if run.walls else None
