"""The port's ``aln -yl2`` (gene prediction) on the CPU against the JAX
package's stdout fixtures, made by

    JAX_PLATFORMS=cpu python -c "from prrn_aln_tpu.cli import aln_main; \\
        aln_main(['-yl2', G, Q])" > tests/fixtures/jax_aln_yl2_<case>.txt

and against the reference's ``-O 5`` golden; the modes not yet ported
exit with an error."""

import contextlib
import io as _io
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu_torch.cli import aln_main

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"

CASES = {"mini": ("mini_gen.fa", "mini_pro.fa"),
         "win_single": ("cet10b9_win31401.fa", "ce13a1_unaligned.fa"),
         "win_msa": ("cet10b9_win31401.fa", "ce13a.msa")}


def _stdout(argv) -> str:
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert aln_main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_aln_yl2_stdout_matches_jax(case):
    g, q = CASES[case]
    got = _stdout(["-yl2", str(FIX / g), str(FIX / q), "--device", "cpu"])
    assert got == (FIX / f"jax_aln_yl2_{case}.txt").read_text()


def test_aln_yl2_O5_matches_reference():
    g, q = CASES["mini"]
    got = _stdout(["-yl", "2", "-O", "5", "-s", str(FIX), g, q,
                   "--device", "cpu"])
    assert got == (FIX / "aln_H_mini_O5.txt").read_text()


@pytest.mark.parametrize("argv, what", [
    (["-a"], "-a"),
    (["-R", "3"], "-R"),
    (["-Ls"], "-L s"),
    (["-M"], "-M"),
    ([], "without -yl2"),
])
def test_unported_modes_exit(argv, what, capsys):
    g, q = CASES["mini"]
    extra = [] if what == "without -yl2" else ["-yl2"]
    with pytest.raises(SystemExit):
        aln_main([*extra, *argv, str(FIX / g), str(FIX / q), "--device",
                  "cpu"])
    err = capsys.readouterr().err
    assert "not yet ported" in err and what in err


def test_dna_query_not_yet_ported(capsys):
    g = str(FIX / "mini_gen.fa")
    with pytest.raises(SystemExit):
        aln_main(["-yl2", g, g, "--device", "cpu"])
    assert "fwd2s" in capsys.readouterr().err


def test_absent_cuda_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, q = CASES["mini"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aln_main(["-yl2", str(FIX / g), str(FIX / q)])
