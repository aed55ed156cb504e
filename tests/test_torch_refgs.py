"""The port's ``refgs`` (concerted gene-structure refinement) on the CPU
against the JAX package's, run with its f32 fwd2h engine: the records,
``;C`` exons, statuses, outliers and the rebuilt MSA's rows equal the
fixtures ``jax_refgs_{ok,perturbed,cli}.txt`` (``tools/write_jax_fixtures.py``).

The family is built from files in the repository as
``tests/test_refgs.py`` builds it from the reference's samples
(``chip_smoke.refgs_family_inputs``)."""

import contextlib
import dataclasses
import io as _io
import sys
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu_torch import refgs as rg
from prrn_aln_tpu_torch.cli import refgs_main
from prrn_aln_tpu_torch.io import SeqRecord

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT))
from chip_smoke import (REFGS_BAD, REFGS_EXONS,  # noqa: E402
                        refgs_family_inputs, refgs_text, write_refgs_inputs)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def family():
    g, fam = refgs_family_inputs()
    return g, [SeqRecord(name, seq, exons=exons) for name, seq, exons in fam]


def _genome_of(g):
    def genome_of(name):
        return (g, 0) if name == "ce13a1" else None
    return genome_of


def test_family_is_the_reference_window(family):
    g, members = family
    assert len(g) == 901 and len(members) == 7
    assert members[0].exons == REFGS_EXONS
    assert [len(m.seq) for m in members[1:]] == [172] * 6


def test_refgs_ok_when_unchanged(family):
    g, members = family
    res = rg.refgs_family(members, _genome_of(g), iters=2, rebuild=False,
                          device="cpu")
    assert res.status["ce13a1"] == "ok" and res.iters == 1
    assert refgs_text(res) == (FIX / "jax_refgs_ok.txt").read_text()


def test_refgs_fixes_perturbed_member(family):
    g, members = family
    bad = [dataclasses.replace(members[0], exons=list(REFGS_BAD)),
           *members[1:]]
    res = rg.refgs_family(bad, _genome_of(g), iters=2, rebuild=True,
                          device="cpu")
    assert [tuple(e) for e in res.records[0].exons] == REFGS_EXONS
    assert res.msa is not None and res.msa.many == len(members)
    assert refgs_text(res) == (FIX / "jax_refgs_perturbed.txt").read_text()


def test_refgs_cli(tmp_path):
    fam, gen = write_refgs_inputs(tmp_path, *refgs_family_inputs())
    out = tmp_path / "refgs_out.fa"
    err = _io.StringIO()
    with contextlib.redirect_stderr(err):
        assert refgs_main(["-n", gen, "-m", "ce13a1", "-I", "1", "-t",
                           str(out), "-pq", fam, "--device", "cpu"]) == 0
    got = out.read_text() + "--- stderr\n" + err.getvalue()
    assert got == (FIX / "jax_refgs_cli.txt").read_text()
    assert ";C join(66..251,307..651)" in got


def test_refgs_cli_absent_cuda_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fam, gen = write_refgs_inputs(tmp_path, *refgs_family_inputs())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        refgs_main(["-n", gen, "-pq", fam])
