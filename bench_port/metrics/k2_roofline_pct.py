"""k2_roofline_pct (%), layer kernels, moves throughput: K2's least
time over its device time, summed over the traced window's calls.
Device time: CUDA events around each ``group_wavefront_launch``; least
time: ``harness.roofline`` over the work its inputs need (real pairs and
members, in-band cells)."""

from harness import roofline

LAYER = "kernels"


def read(run):
    return roofline.share(run, "k2")
