"""The port's prrn on the flagship family, plain versions on the CPU:
byte-identical to the JAX package's output fixture (generated from
``prrn_aln_tpu.cli.prrn_main(["-R", "0", ...])``), with every row of the
reference's golden alignment exact; and on fam19 (19 proteins), which
takes the single-linkage forest path, against fixtures made the same way
(``jax_prrn_fam19_R0.txt``; ``jax_prrn_fam19_R0_I0.txt`` with ``-I 0``)."""

import re
from pathlib import Path

import pytest
import torch

from prrn_aln_tpu_torch import alphabet as ab, io, scoring
from prrn_aln_tpu_torch.cli import prrn_main
from prrn_aln_tpu_torch.config import default_params
from prrn_aln_tpu_torch.msa import slforest
from prrn_aln_tpu_torch.pipeline import FOREST_MIN_SEQS

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


def test_forest_path_not_ported(capsys):
    """What the forest path still lacks: dumping the sub-MSAs (``-e``)
    and the update mode's flags exit as not yet ported."""
    recs = io.read_fasta(FIX / "fam19.fa")
    assert len(recs) >= FOREST_MIN_SEQS
    for flags in (["-e", "sub"], ["-G", "groups.txt"], ["-U"]):
        with pytest.raises(SystemExit):
            prrn_main([*flags, str(FIX / "fam19.fa"), "--device", "cpu"])
        assert "not yet ported" in capsys.readouterr().err


def test_fam19_forest_without_refinement_matches_jax_fixture(tmp_path):
    """The forest path at full width (k-mer filter, 27 edges, 7 trees, 6
    batched launches, 6 host merges), ``-I 0``: about 80 s here."""
    out = tmp_path / "msa.txt"
    assert prrn_main(["-R", "0", "-I", "0", str(FIX / "fam19.fa"), "-o",
                      str(out), "--device", "cpu"]) == 0
    assert out.read_text() == (FIX / "jax_prrn_fam19_R0_I0.txt").read_text()


@pytest.mark.slow
def test_fam19_matches_jax_fixture(tmp_path):
    """The whole run with refinement.  Slow: it makes 231 group
    alignments, most of them of 19 members, and their plain version took
    1,010 s on one CPU core, two thirds of what the whole suite may
    take.  The same bytes are checked on the card by ``chip_smoke.py``."""
    out = tmp_path / "msa.txt"
    assert prrn_main(["-R", "0", str(FIX / "fam19.fa"), "-o", str(out),
                      "--device", "cpu"]) == 0
    assert out.read_text() == (FIX / "jax_prrn_fam19_R0.txt").read_text()


def _tree_shape(node):
    if node.left is None:
        return node.tid
    return (_tree_shape(node.left), _tree_shape(node.right))


def test_fam19_switch_leaves_edges_and_forest(monkeypatch):
    """``PRRN_PW_FUSED=1`` sends the edge pass over the row sweep; the
    edge list, its order and the forest stay as they were."""
    recs = io.read_fasta(FIX / "fam19.fa")
    params = default_params(ab.PROTEIN, "prrn")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    seqs = [ab.encode(r.seq.replace("-", ""), ab.PROTEIN) for r in recs]
    got = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("PRRN_PW_FUSED", switch)
        edges = slforest.candidate_edges(
            seqs, ab.PROTEIN, mtx, u=params.u, v=params.v, sh=params.sh,
            thr=params.thr, device="cpu")
        trees, singles = slforest.build_forest(len(seqs), edges,
                                               thr=params.thr)
        got[switch] = (edges, [_tree_shape(t) for t in trees], singles)
    off, on = got["0"], got["1"]
    assert [(e.u, e.v) for e in on[0]] == [(e.u, e.v) for e in off[0]]
    assert len(off[0]) == 27
    order = [sorted(range(27), key=lambda k: x[0][k].dist) for x in (off, on)]
    assert order[0] == order[1]
    assert on[1:] == off[1:]
    assert [len(str(t).split(",")) for t in off[1]] == [7, 2, 2, 2, 2, 2, 2]
    assert max(abs(a.dist - b.dist) for a, b in zip(off[0], on[0])) < 1e-4
