"""The port's prrn on the flagship family, plain versions on the CPU:
byte-identical to the JAX package's output fixture (generated from
``prrn_aln_tpu.cli.prrn_main(["-R", "0", ...])``), with every row of the
reference's golden alignment exact."""

import re
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu_torch.cli import prrn_main
from prrn_aln_tpu_torch.pipeline import FOREST_MIN_SEQS, build_msa
from prrn_aln_tpu_torch import io

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _rows(text):
    rows = {}
    for line in text.splitlines():
        mt = re.match(r"\s*\d+ (.{1,61})\| (\S+)", line)
        if mt:
            rows.setdefault(mt.group(2), []).append(mt.group(1).rstrip())
    return {k: "".join(v) for k, v in rows.items()}


def test_ce13a17_matches_jax_fixture(tmp_path):
    out = tmp_path / "msa.txt"
    assert prrn_main(["-R", "0", str(FIX / "ce13a17_clean.fa"), "-o",
                      str(out), "--device", "cpu"]) == 0
    text = out.read_text()
    assert text == (FIX / "jax_prrn_ce13a17_clean_R0.txt").read_text()
    golden = _rows((FIX / "golden_prrn_default7.txt").read_text())
    assert _rows(text) == golden


def test_forest_path_not_ported():
    recs = io.read_fasta(FIX / "fam19.fa")
    assert len(recs) >= FOREST_MIN_SEQS
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_msa(recs, device="cpu")
