"""The program's counters as the benchmark reads them: the readers of
``refine_accept_pct``, ``copy_kb``, ``k2_us_per_step`` and
``k3_us_per_move`` on hand-made runs, a traced run on the host (the
program's plain versions), and an untraced run, which leaves the
program's tracer off."""

import collections
import contextlib
import types

import pytest

import run as bench
from harness import load, names

CELL = {"name": "tiny", "chips": 1, "traffic": "family_pool_passes"}
CONFIG = {"generator": "tree_family",
          "entry": {"call": "prrn_aln_tpu_torch.cli:prrn_main",
                    "argv": ["-R", "0", "--device", "cpu", "-o", "{out}",
                             "{fasta}"]},
          "reference": "prrn_ref.pipeline:align_family",
          "family": {"identity": [0.2, 0.4], "length_spread": 0.1,
                     "inner_height": 0.8, "indel_rate": 0.03,
                     "indel_max": 5}}
NEW = ("refine_accept_pct", "copy_kb", "k2_us_per_step", "k3_us_per_move")


def hand_made(launches):
    return bench.Run(
        seconds=10, setup_s=1.0, window_s=10.0, walls=[1.0, 2.0],
        residues=[100, 200], peak_mem_bytes=0,
        kind="NVIDIA H100 80GB HBM3", launches=launches,
        # K2 busy 2.56 + 1.28 ms, K3 0.02 + 0.02 ms
        kernel_ms=[("k2", 0.0, 2.56, None), ("k3", 2.6, 2.62, None),
                   ("k2", 3.0, 4.28, None), ("k3", 4.3, 4.32, None),
                   ("k1", 5.0, 9.0, None)])


def counters():
    return [collections.Counter({
                "group_wavefront": 2, "k2.steps": 512, "k3.moves": 300,
                "refine.attempted": 8, "refine.accepted": 2,
                "copy.h2d_bytes": 30000, "copy.d2h_bytes": 2000}),
            collections.Counter({
                "group_wavefront": 1, "k2.steps": 256, "k3.moves": 100,
                "refine.attempted": 2, "refine.accepted": 1,
                "copy.h2d_bytes": 8000})]


@pytest.mark.parametrize("name,want", [
    ("refine_accept_pct", 30.0),          # 3 of 10
    ("copy_kb", 20.0),                    # 40,000 bytes over 2 families
    ("k2_us_per_step", 5.0),              # 3,840 us over 768 steps
    ("k3_us_per_move", 0.1)])             # 40 us over 400 moves
def test_reader_of_the_programs_counters(name, want):
    run = hand_made(counters())
    assert bench.metric_reader(name)(run) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_the_counters_returns_nothing(name):
    """A program that counts launches only (the parent of these
    counters) gives no reading, and no error."""
    run = hand_made([collections.Counter(group_wavefront=3)])
    assert bench.metric_reader(name)(run) is None


def _no_card(monkeypatch):
    """What the harness's traced run asks of the card, on a host with
    none: the kernel library's launchers (for its events; the plain
    versions never call them) and the synchronise its layer spans start
    and end with."""
    import torch
    from prrn_aln_tpu_torch.ops import _build

    def never(*a):
        raise AssertionError("a kernel launched on the host")
    lib = types.SimpleNamespace(**{load("kernels", k).LAUNCHER: never
                                   for k in names("kernels")})
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def tiny(trace, metrics):
    traffic = {"pool_seed": 2 ** 31 + 3, "pool": [[4, 40]], "checked": 1,
               "fresh": 1}
    return bench.run_cell(CELL, traffic, CONFIG, metrics, seed=2 ** 31 + 3,
                          seconds=0.01, trace=trace, device="cpu",
                          t_start=0.0)


def test_traced_run_on_the_host_reads_the_counters(monkeypatch):
    _no_card(monkeypatch)
    metrics = [{"name": n, "unit": "x"} for n in
               ("refine_ms", "k2_launches") + NEW]
    res = tiny(True, metrics)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # no CUDA events on the host: the per-step readings are absent
    assert set(got) == {"refine_ms", "k2_launches", "refine_accept_pct",
                        "copy_kb"}
    assert 0.0 <= got["refine_accept_pct"] <= 100.0
    assert got["copy_kb"] > 0.0


def test_untraced_run_installs_nothing_and_leaves_the_tracer_off(
        monkeypatch):
    from prrn_aln_tpu_torch.ops import _build
    from prrn_aln_tpu_torch.utils import trace

    def refuse():
        raise AssertionError("an untraced run loaded the kernel library")
    monkeypatch.setattr(_build, "load", refuse)
    drv = load("traffic", CELL["traffic"])
    window, seen = drv.window, []

    def watched(st, seconds):
        seen.append(isinstance(trace.span("probe"), contextlib.nullcontext))
        return window(st, seconds)
    monkeypatch.setattr(drv, "window", watched)
    trace.take()
    res = tiny(False, [{"name": "throughput", "unit": "res/s"}])
    assert res["correct"] is True and "breakdown" not in res
    assert seen == [True]
    assert trace.take() == []
