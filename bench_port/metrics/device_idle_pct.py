"""device_idle_pct (%), layer device, moves throughput: the share of the
traced window in which none of the program's kernels that ``kernels/``
times (K1, K2, K3: CUDA events around their launchers) ran.  PyTorch's
own small operations (packing copies, reductions) fall outside these
intervals, so the share is an upper bound of the card's idle time; the
profiler's ``busy_s`` of the result line counts them."""

from harness.tracing import merged

LAYER = "device"


def read(run):
    if not run.kernel_ms or run.window_s <= 0:
        return None
    busy_ms = sum(e - s for s, e in merged((s, e)
                                           for _, s, e, _ in run.kernel_ms))
    return 100.0 * (1.0 - busy_ms / 1e3 / run.window_s)
