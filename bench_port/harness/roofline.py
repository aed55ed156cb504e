"""The card's published peaks and the yardstick of a kernel's work.

Each kernel's own count sits in ``kernels/<kernel>.py``.  The work is
counted from the layer's own inputs: the real pairs, their
real member counts and lengths, the cells inside each pair's band, each
input byte read once and each output byte written once.  It is never
counted from a launch plan's slots, padding or CTAs, so that a change of
plan or variant cannot move it.  Frozen here so that later changes to
the program cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM at its 700 W limit (copied from
# chip_smoke.py): device memory rate and the rates outside the tensor
# cores in float32 and float64
PEAKS = {"NVIDIA H100 80GB HBM3": {"mem_bps": 3.35e12, "f32_ops": 67e12,
                                   "f64_ops": 34e12}}


def peaks(kind: str) -> dict | None:
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or
    None for a card the table lacks (no roofline share is then read)."""
    return PEAKS.get(kind)


def band_cells(la, lb, lw, up) -> int:
    """Cells inside the band over a batch (the work a GCUPS rate counts);
    copied from ``bench.py::band_cells`` (equal to
    ``prrn_aln_tpu_torch.ops.pairwise.band_cells``)."""
    total = 0
    for a, b, lo, hi in zip(la, lb, lw, up):
        m = np.arange(int(a))
        lo_n = np.maximum(m + int(lo), 0)
        hi_n = np.minimum(m + int(hi), int(b) - 1)
        total += int(np.maximum(hi_n - lo_n + 1, 0).sum())
    return total


def least_seconds(work: dict, peak: dict) -> float:
    """The least time the card needs for ``work``: the larger of its
    bytes over the memory rate and its operations over the float rates."""
    t_bytes = work["bytes"] / peak["mem_bps"]
    t_ops = work["f32_ops"] / peak["f32_ops"] + work["f64_ops"] / peak[
        "f64_ops"]
    return max(t_bytes, t_ops)


def member_counts(w: np.ndarray) -> np.ndarray:
    """Per pair, the members up to the last non-zero weight (at least
    one): the real members (the rest are zero-weight padding)."""
    idx = np.arange(1, w.shape[1] + 1)
    return np.maximum(np.where(w != 0, idx, 0).max(1), 1)


def share(run, kernel: str) -> float | None:
    """A kernel's share of its roofline over a traced window, in %: the
    least time its calls need over their device time; None where the
    kernel did not run or the card is not in ``PEAKS``."""
    peak = peaks(run.kind)
    calls = [(e - s, w) for k, s, e, w in run.kernel_ms
             if k == kernel and w is not None]
    if peak is None or not calls:
        return None
    device_s = sum(ms for ms, _ in calls) / 1e3
    return 100.0 * sum(least_seconds(w, peak) for _, w in calls) / device_s
