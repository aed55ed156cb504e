"""K1, ``csrc/pairwise.cu``: the score-only banded Gotoh of the
distance pass, launched by ``pairwise_scores_launch``.  Its inputs are
kept from ``ops.pairwise._launch_pairwise`` for the work count."""

from __future__ import annotations

import numpy as np

from harness.roofline import band_cells

LAUNCHER = "pairwise_scores_launch"
KEEP = ("prrn_aln_tpu_torch.ops.pairwise", "_launch_pairwise")


def inputs(a_batch, b_batch, la, lb, lw, up, mtx, *rest, **kw) -> dict:
    return {"la": la, "lb": lb, "lw": lw, "up": up, "dim": mtx.shape[0]}


def work(inp: dict) -> dict:
    """K1 over a batch: a band cell takes 3 adds or subtractions and 6
    maxima over H, F and G (9 f32 operations, chip_smoke.py's count); it
    reads each pair's codes (int32), lengths, band, gap costs and
    end-gap flags and the matrix once, and writes one f32 score a
    pair."""
    la, lb = np.asarray(inp["la"], np.int64), np.asarray(inp["lb"], np.int64)
    cells = band_cells(la, lb, inp["lw"], inp["up"])
    pairs = len(la)
    nbytes = 4 * int((la + lb).sum()) + pairs * (7 * 4 + 4) \
        + 4 * inp["dim"] ** 2 + 4 * pairs
    return {"bytes": nbytes, "f32_ops": 9 * cells, "f64_ops": 0,
            "cells": cells}
