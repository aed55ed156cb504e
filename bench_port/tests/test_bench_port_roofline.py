"""The work counts and the roofline share, against hand counts."""

import numpy as np
import pytest

from harness import load, roofline


def test_band_cells_by_hand():
    # 3 x 4, band r = n - m in [-1, 1]: rows 0..2 hold 2, 3, 3 cells
    assert roofline.band_cells([3], [4], [-1], [1]) == 8
    # the full rectangle
    assert roofline.band_cells([3, 2], [4, 2], [-3, -2], [4, 2]) == 16


def test_band_cells_equals_the_ports():
    from prrn_aln_tpu_torch.ops.pairwise import band_cells
    rng = np.random.default_rng(0)
    la = rng.integers(5, 60, 20)
    lb = rng.integers(5, 60, 20)
    lw = -rng.integers(0, 20, 20)
    up = rng.integers(0, 20, 20)
    assert roofline.band_cells(la, lb, lw, up) == band_cells(la, lb, lw, up)


def test_k1_work_by_hand():
    w = load("kernels", "k1").work({"la": [3], "lb": [4], "lw": [-1],
                                    "up": [1], "dim": 2})
    assert w["cells"] == 8 and w["f32_ops"] == 72 and w["f64_ops"] == 0
    # codes 4 * 7, 7 ints and floats and 4 flags, the matrix, one score
    assert w["bytes"] == 4 * 7 + 32 + 16 + 4


def test_k2_work_by_hand():
    live = np.zeros((1, 9), bool)
    live[0, :5] = True
    w = load("kernels", "k2").work({
        "la": [3], "lb": [4], "lw": [-1], "up": [1], "live": live,
        "wa": np.array([[0.5, 0.5, 0.0]]), "wb": np.array([[1.0, 1, 1]]),
        "ls3": False, "whole": True})
    assert w["cells"] == 8 and w["f32_ops"] == 72
    assert w["f64_ops"] == 8 * (2 * 5 + 12 * 2 * 3)
    rows = 6 * 7 + 3 * (4 * 2 + 5 * 3) + 2 * 4 + 2 * 5 + 2 + 3 + 9
    assert w["bytes"] == 4 * rows + 4 + 2 * 8


def test_resumed_k2_chunk_has_no_count():
    assert load("kernels", "k2").work({"whole": False}) is None


def test_member_counts_skip_zero_weight_padding():
    w = np.array([[0.5, 0.2, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    assert roofline.member_counts(w).tolist() == [2, 1]


def test_least_seconds_takes_the_larger_bound():
    peak = {"mem_bps": 1e3, "f32_ops": 1e3, "f64_ops": 5e2}
    assert roofline.least_seconds(
        {"bytes": 2e3, "f32_ops": 1e3, "f64_ops": 0}, peak) == 2.0
    assert roofline.least_seconds(
        {"bytes": 1e3, "f32_ops": 1e3, "f64_ops": 1e3}, peak) == 3.0


class _Run:
    kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, kernel_ms):
        self.kernel_ms = kernel_ms


def test_share_over_calls():
    peak = roofline.PEAKS[_Run.kind]
    work = {"bytes": 0, "f32_ops": peak["f32_ops"] * 1e-3, "f64_ops": 0}
    # 1 ms of least time over 4 ms of device time in two calls
    run = _Run([("k1", 0.0, 2.0, work), ("k1", 5.0, 7.0, None),
                ("k1", 9.0, 11.0, work), ("k2", 0.0, 1.0, work)])
    assert roofline.share(run, "k1") == pytest.approx(50.0)
    assert roofline.share(run, "k3") is None
    run.kind = "another card"
    assert roofline.share(run, "k1") is None


def test_merged_intervals():
    from harness.tracing import merged
    assert merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
