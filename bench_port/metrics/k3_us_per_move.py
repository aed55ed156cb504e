"""k3_us_per_move (us/move), layer kernels, moves throughput: K3's
device time (CUDA events around each ``traceback_launch``,
``kernels/k3.py``) over the moves its walks made (the program's counter
``k3.moves``, summed from the counts it copies back) in the traced
window.  None without K3 events or without the counter."""

LAYER = "kernels"


def read(run):
    moves = sum(c["k3.moves"] for c in run.launches)
    calls = [e - s for k, s, e, _ in run.kernel_ms if k == "k3"]
    if not moves or not calls:
        return None
    return 1e3 * sum(calls) / moves
