"""The traffic: generators deterministic from the seed and inside their
configuration's ranges; every name a file of the benchmark resolves."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest

from harness import families as fam, load

BENCH = Path(__file__).resolve().parent.parent
CONFIGS = BENCH / "configs"
WORKLOADS = BENCH / "workloads"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


class _Job:
    def __init__(self, tmp):
        self.tmp, self.seen = tmp, []
        self.request = contextlib.nullcontext

    def call(self, fasta, out):
        self.seen.append(fasta.name)
        out.write_text("")
        return 0


def test_window_passes_over_the_whole_pool(tmp_path):
    drv = load("traffic", "family_pool_passes")
    made = [fam.Family(["a"], ["M" * (k + 1)]) for k in range(4)]
    st = drv.State(_Job(tmp_path), made,
                   [tmp_path / f"f{k}.fa" for k in range(4)])
    rec = drv.window(st, 0.05)
    n = rec["attempted"]
    assert n >= 1 and rec["failed"] == 0 and len(rec["walls"]) == n
    assert st.job.seen == [f"f{k % 4}.fa" for k in range(n)]
    assert rec["residues"] == [k % 4 + 1 for k in range(n)]


@pytest.mark.parametrize("pool_seed", [0, 7, 2 ** 31 + 5])
def test_protein_pool_in_range_and_repeatable(pool_seed):
    cfg = config("prrn_protein_balibase")
    shapes = [[6, 150], [15, 160], [8, 300]]
    first = fam.pool([pool_seed, 2], cfg, shapes)
    assert [f.seqs for f in first] == [f.seqs
                                       for f in fam.pool([pool_seed, 2], cfg,
                                                         shapes)]
    assert first[1].seqs == fam.pool([pool_seed, 2], cfg,
                                     shapes[:2])[1].seqs
    assert fam.pool([pool_seed, 9], cfg, shapes)[0].seqs != first[0].seqs
    lo, hi = cfg["family"]["identity"]
    for f, (n, length) in zip(first, shapes):
        assert len(f.seqs) == n < 16
        assert cfg["sequences"][0] <= n <= cfg["sequences"][1]
        assert all(0.9 * length <= len(s) <= 1.1 * length for s in f.seqs)
        assert lo <= f.identity <= hi
        assert set("".join(f.seqs)) <= set(fam.AMINO)


def test_protein_identity_is_what_the_true_alignment_says():
    a = np.array([1, 2, 3, 4, 5])
    b = np.array([7, 1, 9, 3, 4])        # one inserted, 4 deleted, 1 changed
    b_ids = np.array([-1, 0, 1, 2, 3])
    tree_family = load("generators", "tree_family")
    assert tree_family.pairwise_identity(a, np.arange(5), b, b_ids) == 0.75


def test_every_name_resolves():
    import importlib
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    for cell in spec["workloads"]:
        w = json.loads((WORKLOADS / f"{cell['name']}.json").read_text())
        assert w["config"] == cell["config"]
        drv = load("traffic", cell["traffic"])
        assert callable(drv.prepare) and callable(drv.window)
        assert callable(drv.check_outputs)
        cfg = json.loads((BENCH.parent / configs[w["config"]]["file"])
                         .read_text())
        assert callable(load("generators", cfg["generator"]).make)
        module, function = cfg["reference"].split(":")
        assert callable(getattr(importlib.import_module(module), function))
        module, function = cfg["entry"]["call"].split(":")
        assert callable(getattr(importlib.import_module(module), function))


def test_workload_files_name_their_configs():
    for path in WORKLOADS.glob("*.json"):
        w = json.loads(path.read_text())
        assert (CONFIGS / f"{w['config']}.json").exists()
        assert set(w) == {"config", "pool_seed", "pool", "checked", "fresh"}
        assert all(cfg_n < 16 for cfg_n, _ in w["pool"])
        cfg = config(w["config"])
        for n, length in w["pool"]:
            assert cfg["sequences"][0] <= n <= cfg["sequences"][1]
            assert cfg["length"][0] <= length <= cfg["length"][1]
