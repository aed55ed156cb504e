"""K2, ``csrc/group_wavefront.cu``: the banded group-to-group profile DP
of the merges and the refinement, launched by ``group_wavefront_launch``.
Its inputs are kept from ``ops.group.group_wavefront`` for the work
count."""

from __future__ import annotations

import numpy as np

from harness.roofline import band_cells, member_counts

LAUNCHER = "group_wavefront_launch"
KEEP = ("prrn_aln_tpu_torch.ops.group", "group_wavefront")


def inputs(ins, *, ls3=False, **kw) -> dict:
    return {"la": ins["la"], "lb": ins["lb"], "lw": ins["lw"],
            "up": ins["up"], "wa": ins["wa"], "wb": ins["wb"],
            # the profile channels that carry data
            "live": (ins["CA"] != 0).any(1) | (ins["CB"] != 0).any(1),
            "ls3": ls3,
            "whole": kw.get("d0", 0) == 0 and kw.get("carry") is None}


def work(inp: dict) -> dict | None:
    """K2 over a batch of pairs (None for a resumed chunk): a band cell
    takes the profile product (a multiply and an add a channel that
    carries data, f64), the six crg sums (a multiply and an add a real
    member pair each, f64) and the lane update (9 f32), as chip_smoke.py's
    ``k2_bound`` counts it.  Bytes: each pair's channel stacks and gap
    bonuses (la and lb rows), its three member factor arrays a side
    ((la + 1) x an, (lb + 1) x bn), its four column flags, weights and
    nine scalars read once; its score, and one direction and one
    gap-open byte a band cell, written once."""
    if not inp["whole"]:
        return None
    la, lb = np.asarray(inp["la"], np.int64), np.asarray(inp["lb"], np.int64)
    an, bn = member_counts(inp["wa"]), member_counts(inp["wb"])
    channels = np.asarray(inp["live"], np.int64).sum(1)
    cells = np.array([band_cells([a], [b], [lo], [hi])
                      for a, b, lo, hi in zip(la, lb, inp["lw"], inp["up"])],
                     np.int64)
    lanes = 5 if inp["ls3"] else 3
    rows_in = ((channels + 1) * (la + lb) + 3 * ((la + 1) * an
                                                 + (lb + 1) * bn)
               + 2 * (la + 1) + 2 * (lb + 1) + an + bn + 9)
    nbytes = 4 * int(rows_in.sum()) + 4 * len(la) + 2 * int(cells.sum())
    f64 = int((cells * (2 * channels + 4 * lanes * an * bn)).sum())
    return {"bytes": nbytes, "f32_ops": 9 * int(cells.sum()), "f64_ops": f64,
            "cells": int(cells.sum())}
