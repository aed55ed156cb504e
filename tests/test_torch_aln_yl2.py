"""The port's ``aln -yl2`` (gene prediction) on the CPU against the JAX
package's stdout fixtures, made by

    JAX_PLATFORMS=cpu python -c "from prrn_aln_tpu.cli import aln_main; \\
        aln_main(['-yl2', G, Q])" > tests/fixtures/jax_aln_yl2_<case>.txt

and against the reference's ``-O 5`` golden; the other modes against
the JAX CLI; a DNA query (fwd2s) against the JAX f32 engine's output
``jax_aln_yl2_mini_dna.txt`` (``tools/write_jax_fixtures.py``)."""

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
def test_unported_modes_exit(argv, what, tmp_path):
    """The modes that once exited "not yet ported", each against the JAX
    CLI on inputs of its kind: the pileup (``-a``) of three proteins, the
    shuffle test (``-R``) and the plain pair (no ``-yl2``) of mini_pro x
    ce13a1, the local colonies (``-L s``) of loc_a x loc_b, and the
    both-strand search (``-M``) of a DNA pair, the second reversed and
    complemented."""
    from prrn_aln_tpu.cli import aln_main as jax_aln_main
    pro = [str(FIX / "mini_pro.fa"), str(FIX / "ce13a1_unaligned.fa")]
    if what == "-a":
        recs = (FIX / "idn_p.fa").read_text().splitlines()
        third = tmp_path / "third.fa"
        third.write_text(">prC\n" + "".join(recs[1:])[:90] + "\n")
        inputs = [*pro, str(third)]
    elif what == "-L s":
        inputs = [str(FIX / "loc_a.fa"), str(FIX / "loc_b.fa")]
    elif what == "-M":
        seq = "".join((FIX / "loc_a.fa").read_text().splitlines()[1:])
        comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
        (tmp_path / "x.fa").write_text(">x\n" + seq + "\n")
        (tmp_path / "y.fa").write_text(
            ">y\n" + "".join(comp[c] for c in reversed(seq[20:200])) + "\n")
        inputs = [str(tmp_path / "x.fa"), str(tmp_path / "y.fa")]
    else:
        inputs = pro
    outs = []
    for main, extra in ((aln_main, ["--device", "cpu"]), (jax_aln_main, [])):
        out, err = _io.StringIO(), _io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert main([*argv, *inputs, *extra]) == 0
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0]


def _long_protein() -> list:
    return [str(FIX / "long_protein_gen.fa"), str(FIX / "long_protein_pro.fa")]


def test_long_protein_fixture_is_lp2100():
    """The long-protein fixture is chip_smoke.long_protein_gene's lp2100
    (2,100 residues in 10 exons, ~8.5 kb), as chip_smoke.py and
    tools/k4_bench.py make it."""
    import sys
    from prrn_aln_tpu_torch import io as tio
    sys.path.insert(0, str(FIX.parent.parent))
    from chip_smoke import LONG_PROTEINS, long_protein_gene
    g, p = long_protein_gene(*LONG_PROTEINS["lp2100"])
    got = [tio.sniff_and_read(path)[0].seq for path in _long_protein()]
    assert got == [g, p] and len(p) == 2100


@pytest.mark.slow
def test_aln_yl2_long_protein_matches_jax_scan_engine():
    """A protein past 2,048 rows (lp2100: 2,101 rows, 14,774 waves, the
    rows K4 takes on chained clusters on the card) against the JAX scan
    engine's output (``jax_aln_yl2_long_protein.txt``, which the JAX
    CLI's default CPU engine gives too).  Slow: the plain sweep takes
    ~6 minutes on one core; chip_smoke.py holds the card's output to the
    same bytes."""
    got = _stdout(["-yl2", *_long_protein(), "--device", "cpu"])
    assert got == (FIX / "jax_aln_yl2_long_protein.txt").read_text()


def test_dna_query_matches_jax_f32_engine():
    g = str(FIX / "mini_gen.fa")
    got = _stdout(["-yl2", g, g, "--device", "cpu"])
    assert got == (FIX / "jax_aln_yl2_mini_dna.txt").read_text()


def test_absent_cuda_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, q = CASES["mini"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aln_main(["-yl2", str(FIX / g), str(FIX / q)])
