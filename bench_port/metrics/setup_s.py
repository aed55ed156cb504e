"""setup_s (s), end to end, host clock: from the process's start to the
window's start (imports, the CUDA context, loading or building the
kernel library, one warm-up family of the cell's own shapes)."""

LAYER = "CLI"


def read(run):
    return run.setup_s
