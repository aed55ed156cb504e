"""The port's ``aln -G`` (a cDNA against genomic DNA, fwd2s) on the CPU
against the JAX package's f32 engine, whose standard output is in
``tests/fixtures/jax_aln_G_gen{1,2}_<mode>.txt`` (made by
``tools/write_jax_fixtures.py``), and against the reference's goldens
``aln_G_gen{1,2}_<mode>.txt``: gen1 equals them in every mode; gen2
differs in all but ``-O 3``, because the f32 engine breaks one score tie
the other way than the reference's float64 DP (one gap on the other
side of an exon boundary), and the port follows the f32 engine."""

import contextlib
import functools
import io as _io
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu_torch.cli import aln_main

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
MODES = {"O0": ["-O", "0"], "O2": ["-O", "2"], "O3": ["-O", "3"],
         "O4": ["-O", "4"], "O5": ["-O", "5"], "default": []}
# the modes in which gen2's f32 output differs from the reference's golden
GEN2_TIE_MODES = ("O0", "O2", "O4", "O5", "default")


@functools.lru_cache(maxsize=None)
def _aln_G(case: int, mode: str) -> str:
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert aln_main(["-G", *MODES[mode], str(FIX / f"gen{case}.fa"),
                         str(FIX / f"cdna{case}.fa"), "--device",
                         "cpu"]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", [1, 2])
def test_aln_G_matches_jax_f32_engine(case, mode):
    want = (FIX / f"jax_aln_G_gen{case}_{mode}.txt").read_text()
    assert _aln_G(case, mode) == want


@pytest.mark.parametrize("mode", list(MODES))
def test_aln_G_gen1_matches_reference(mode):
    assert _aln_G(1, mode) == (FIX / f"aln_G_gen1_{mode}.txt").read_text()


def test_aln_G_gen2_f32_tie_differs_from_reference():
    """gen2's known f32 tie: every mode that prints the path or the
    exons differs from the reference's golden, -O 3 (the BED line) does
    not."""
    for mode in MODES:
        gold = (FIX / f"aln_G_gen2_{mode}.txt").read_text()
        assert (_aln_G(2, mode) != gold) == (mode in GEN2_TIE_MODES), mode


def test_aln_G_output_file(tmp_path):
    out = tmp_path / "g.txt"
    assert aln_main(["-G", "-O", "4", "-o", str(out), str(FIX / "gen1.fa"),
                     str(FIX / "cdna1.fa"), "--device", "cpu"]) == 0
    assert out.read_text() == _aln_G(1, "O4")


def test_absent_cuda_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aln_main(["-G", str(FIX / "gen1.fa"), str(FIX / "cdna1.fa")])
