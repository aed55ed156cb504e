"""k1_roofline_pct (%), layer kernels, moves throughput: K1's least
time over its device time, summed over the traced window's calls.
Device time: CUDA events around each ``pairwise_scores_launch``; least
time: ``harness.roofline`` over the work its inputs need."""

from harness import roofline

LAYER = "kernels"


def read(run):
    return roofline.share(run, "k1")
