"""Each metric reader on a synthetic run."""

import collections
import json
from pathlib import Path

import pytest

import run as bench

ROOT = Path(__file__).resolve().parent.parent.parent


def synthetic():
    peak = {"bytes": 0, "f32_ops": 67e12 * 1e-4, "f64_ops": 0}   # 0.1 ms
    return bench.Run(
        seconds=10, setup_s=12.5, window_s=10.0, walls=[1.0, 2.0, 3.0, 4.0],
        residues=[100, 200, 300, 400], peak_mem_bytes=3e9,
        kind="NVIDIA H100 80GB HBM3",
        spans=[("distance", 0.01), ("distance", 0.03), ("progressive", 0.2),
               ("refine", 0.5), ("refine", 0.7)],
        launches=[collections.Counter(group_wavefront=3, traceback=3),
                  collections.Counter(group_wavefront=5),
                  collections.Counter(), collections.Counter(pairwise=1)],
        kernel_ms=[("k1", 0.0, 1.0, peak), ("k2", 0.5, 2.0, peak),
                   ("k2", 3000.0, 3001.0, peak), ("k3", 3001.0, 3002.0, None)])


@pytest.mark.parametrize("name,want", [
    ("throughput", 100.0), ("setup_s", 12.5), ("peak_mem_gb", 3.0),
    ("latency_p95_s", 3.85), ("distance_ms", 10.0),
    ("progressive_ms", 50.0), ("refine_ms", 300.0), ("k2_launches", 2.0),
    ("k1_roofline_pct", 10.0), ("k2_roofline_pct", 8.0),
    # kernels busy over [0, 2] and [3000, 3002] ms of a 10 s window
    ("device_idle_pct", 99.96)])
def test_reader(name, want):
    assert bench.metric_reader(name)(synthetic()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["throughput", "latency_p95_s",
                                  "distance_ms", "k2_launches",
                                  "k1_roofline_pct", "device_idle_pct"])
def test_reader_with_nothing_to_read_returns_nothing(name):
    run = bench.Run(seconds=10, setup_s=1.0, window_s=10.0, walls=[],
                    residues=[], peak_mem_bytes=0, kind="cpu")
    assert bench.metric_reader(name)(run) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))
