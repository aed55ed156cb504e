"""The port's guided and grouped modes, plain versions on the CPU,
against the JAX package: ``prrn -b guide5.nwk`` (progressive along the
user's tree, then refinement; rows equal to the reference's golden),
``aln -b`` (no refinement) and ``prrn -G`` (grouped refinement of one
pre-aligned input, written from ``jax_prrn_ce13a17_clean_R0.txt``'s
rows).

``jax_prrn_guided5_R0.txt`` and ``jax_prrn_G_ce13a17.txt`` are the JAX
package's outputs, written by ``tools/write_jax_fixtures.py``; the other
cases run both packages.  The tree's leaves are paths relative to
``tests/fixtures``, so the runs start there, as tests/test_guided.py's."""

import contextlib
import io as _io
import re
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu.cli import aln_main as jax_aln_main
from prrn_aln_tpu.cli import prrn_main as jax_prrn_main
from prrn_aln_tpu_torch import io as pio
from prrn_aln_tpu_torch.cli import aln_main, prrn_main
from prrn_aln_tpu_torch.msa.sets import Subset

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
GROUPS = "1 2/3-5/6"


def _stdout(main, argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _rows(text):
    rows = {}
    for line in text.splitlines():
        mt = re.match(r"\s*\d+ (.{1,61})\| (\S+)", line)
        if mt:
            rows.setdefault(mt.group(2), []).append(mt.group(1).rstrip())
    return {k: "".join(v) for k, v in rows.items()}


def test_prrn_guided_without_refinement_matches_jax(monkeypatch):
    monkeypatch.chdir(FIX)
    argv = ["-b", "guide5.nwk", "-R", "0", "-I", "0"]
    got = _stdout(prrn_main, [*argv, "--device", "cpu"])
    assert got == _stdout(jax_prrn_main, argv)
    assert len(_rows(got)) == 5


def test_prrn_guided_matches_jax_fixture_and_golden(monkeypatch):
    """``prrn -b guide5.nwk -R 0``: byte-identical to the JAX package,
    every row equal to the reference's (by name: the row order follows
    the operand swaps, as tests/test_guided.py notes)."""
    monkeypatch.chdir(FIX)
    got = _stdout(prrn_main, ["-b", "guide5.nwk", "-R", "0",
                              "--device", "cpu"])
    assert got == (FIX / "jax_prrn_guided5_R0.txt").read_text()
    golden = _rows((FIX / "golden_prrn_guided5.txt").read_text())
    assert _rows(got) == golden


@pytest.mark.parametrize("fmt", ["native", "fasta"])
def test_aln_guided_matches_jax(fmt, monkeypatch, tmp_path):
    """``aln -b``: the progressive MSA only; the tree is read from
    another directory, so its leaves resolve beside it."""
    monkeypatch.chdir(tmp_path)
    argv = ["-b", str(FIX / "guide5.nwk"), "-F", fmt]
    got = _stdout(aln_main, [*argv, "--device", "cpu"])
    assert got == _stdout(jax_aln_main, argv)
    assert got.count("ce13a") >= 5


def test_prrn_grouped_matches_jax_fixture(tmp_path):
    """``prrn -G '1 2/3-5/6' -R 0``: refinement whose bipartitions never
    split a group, on one pre-aligned input."""
    path = tmp_path / "ce13a17_aligned.fa"
    recs = pio.sniff_and_read(FIX / "jax_prrn_ce13a17_clean_R0.txt")
    path.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    got = _stdout(prrn_main, ["-R", "0", "-G", GROUPS, str(path),
                              "--device", "cpu"])
    assert got == (FIX / "jax_prrn_G_ce13a17.txt").read_text()
    assert Subset.from_string(len(recs), GROUPS).num == 4
