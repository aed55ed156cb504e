"""k2_us_per_step (us/step), layer kernels, moves throughput: K2's
device time (CUDA events around each ``group_wavefront_launch``,
``kernels/k2.py``) over the anti-diagonal steps its launches walked
(the program's counter ``k2.steps``: each launch's ``nsteps``, bucketed
as launched) in the traced window.  None without K2 events or without
the counter."""

LAYER = "kernels"


def read(run):
    steps = sum(c["k2.steps"] for c in run.launches)
    calls = [e - s for k, s, e, _ in run.kernel_ms if k == "k2"]
    if not steps or not calls:
        return None
    return 1e3 * sum(calls) / steps
