"""A whole run on the host at a tiny size (the program's plain
versions, ``device="cpu"``): the result line's keys, ``correct`` true on
the sound path, and false with the timed path broken underneath."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import run as bench
from harness import check, families as fam
from harness.reference import reference_rows

ROOT = Path(__file__).resolve().parent.parent.parent
CELL = {"name": "tiny", "chips": 1, "traffic": "family_pool_passes"}
REF = "prrn_ref.pipeline:align_family"
CONFIG = {"generator": "tree_family",
          "entry": {"call": "prrn_aln_tpu_torch.cli:prrn_main",
                    "argv": ["-R", "0", "--device", "cpu", "-o", "{out}",
                             "{fasta}"]},
          "reference": REF,
          "family": {"identity": [0.2, 0.4], "length_spread": 0.1,
                     "inner_height": 0.8, "indel_rate": 0.03,
                     "indel_max": 5}}
METRICS = [{"name": "throughput", "unit": "res/s"},
           {"name": "peak_mem_gb", "unit": "GB"},
           {"name": "setup_s", "unit": "s"}]


def tiny_run(seed, shape=(5, 60), fresh=1):
    traffic = {"pool_seed": seed, "pool": [list(shape)], "checked": 1,
               "fresh": fresh}
    return bench.run_cell(CELL, traffic, CONFIG, METRICS, seed=seed,
                          seconds=0.01, trace=False, device="cpu",
                          t_start=0.0)


def test_result_has_the_contract_keys():
    res = tiny_run(2 ** 31 + 3)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"throughput", "peak_mem_gb", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"]["rows_differ"]["limit"] == 0
    # the window's family and a fresh one of the seed
    assert res["checks"]["rows_differ"]["families_checked"] == 2
    json.dumps(res)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "prrn-protein.rv12", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_read_native_reads_the_writer():
    from prrn_aln_tpu_torch import alphabet as ab, io
    from prrn_aln_tpu_torch.msa.msa import msa_from_strings
    rows = ["MKV-LA" * 15, "MKVQLA" * 15, "-KVQL-" * 15]
    m = msa_from_strings(rows, ab.PROTEIN, names=["a", "bb", "c"])
    got = check.read_native(io.write_native_block(m))
    assert got == list(zip(["a", "bb", "c"], rows))
    assert check.rows_differ(got, got) == 0
    assert check.rows_differ(got, got[::-1]) == 2
    assert check.rows_differ(got[:2], got) == 1


def _alter_a_token(monkeypatch):
    from prrn_aln_tpu_torch import io
    write = io.write_native_block

    def altered(msa, *a, **kw):
        codes = msa.codes.copy()
        j = int(np.flatnonzero(codes[0] > 1)[0])
        codes[0, j] = 5 if codes[0, j] != 5 else 6
        msa.codes = codes
        return write(msa, *a, **kw)
    monkeypatch.setattr(io, "write_native_block", altered)


def _refinement_returns_its_state(monkeypatch):
    from prrn_aln_tpu_torch import pipeline
    from prrn_aln_tpu_torch.msa.refine import RefineResult
    monkeypatch.setattr(pipeline, "refine_with_consreg",
                        lambda msa, *a, **kw: RefineResult(msa, None, 0, 0))


def _half_the_distance_batch_left_out(monkeypatch):
    from prrn_aln_tpu_torch.msa import distance
    scores = distance.pairwise_scores

    def half(*a, **kw):
        out = scores(*a, **kw)
        keep = out.shape[0] - out.shape[0] // 2
        out[keep:] = out[:keep].mean()
        return out
    monkeypatch.setattr(distance, "pairwise_scores", half)


def _lowered_reference_in_the_programs_place(monkeypatch):
    """The control: the entry writes the reference's alignment computed
    one float step lower, as the program writes its own."""
    from prrn_aln_tpu_torch import alphabet as ab, cli, io
    from prrn_aln_tpu_torch.msa.msa import msa_from_strings

    def control(argv):
        out, fasta = argv[argv.index("-o") + 1], argv[-1]
        names, seqs = [], []
        for block in open(fasta).read().split(">")[1:]:
            head, *body = block.splitlines()
            names.append(head.strip())
            seqs.append("".join(body))
        rows = reference_rows((REF, names, seqs, "lowered"))
        m = msa_from_strings([r for _, r in rows], ab.PROTEIN,
                             names=[n for n, _ in rows])
        Path(out).write_text(io.write_native_block(m))
        return 0
    monkeypatch.setattr(cli, "prrn_main", control)


# seeds at which the fault's layer does change the alignment (a family
# whose refinement moves nothing cannot show a refinement left out)
@pytest.mark.parametrize("fault,seed", [
    (_alter_a_token, 2 ** 31 + 3),
    (_refinement_returns_its_state, 2 ** 31 + 3),
    (_half_the_distance_batch_left_out, 2 ** 31 + 3),
    (_lowered_reference_in_the_programs_place, 2 ** 31 + 3)])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, seed):
    fault(monkeypatch)
    res = tiny_run(seed, shape=(6, 80))
    assert res["correct"] is False
    assert res["checks"]["rows_differ"]["value"] > 0


def test_control_in_lower_precision_differs():
    f = fam.pool([2 ** 31 + 3, 2], CONFIG, [[6, 80]])[0]
    want = reference_rows((REF, f.names, f.seqs, None))
    # the control's engine at the stated precision is the reference
    assert reference_rows((REF, f.names, f.seqs, "torch_k2")) == want
    got = reference_rows((REF, f.names, f.seqs, "lowered"))
    assert check.rows_differ(got, want) > 0
