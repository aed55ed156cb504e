"""k2_launches (launches/family), layer refine (the refinement launches
most of them), moves throughput: the program's own counter
``_build.LAUNCHES["group_wavefront"]`` over the families of the traced
window."""

LAYER = "refine"


def read(run):
    if not run.walls:
        return None
    return sum(c["group_wavefront"] for c in run.launches) / len(run.walls)
