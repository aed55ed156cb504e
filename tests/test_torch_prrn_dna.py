"""The port's ``prrn`` on a DNA family, plain versions on the CPU, against
the JAX package's ``prrn_main`` on the CPU, byte for byte: the DNA path
of ``prrn`` (the DNA matrix, K1's DNA pairwise scores, K2's progressive
merges and refinement on one-member and group profiles) end to end.
``tests/fixtures/dnafam.fa`` holds 6 DNA sequences of ~300 nt; both runs
take ~20 s together."""

import contextlib
import io as _io
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu.cli import prrn_main as jax_prrn_main
from prrn_aln_tpu_torch.cli import prrn_main

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _stdout(main, argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("flags", [["-R", "0"], ["-R", "0", "-I", "0"]])
def test_prrn_dna_family_matches_jax(flags):
    argv = [*flags, str(FIX / "dnafam.fa")]
    got = _stdout(prrn_main, [*argv, "--device", "cpu"])
    want = _stdout(jax_prrn_main, argv)
    assert got == want
    assert got.count("| dna0") > 1
