"""Port distance pass (K1 plain version + host UPGMA) vs the JAX package."""

import json
from pathlib import Path

import numpy as np
import torch

from prrn_aln_tpu import alphabet as jab, io as jio, scoring as jscoring
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.msa import distance as jdistance, tree as jtree
from prrn_aln_tpu_torch.msa import distance, tree

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _tree_fields(t):
    return [np.asarray(getattr(t, k)) for k in
            ("left", "right", "parent", "height", "length", "res", "ndesc")]


def test_ce13a17_distances_and_tree_match_jax():
    recs = jio.read_fasta(FIX / "ce13a17_clean.fa")
    molc = jab.infer_molc(recs[0].seq)
    params = jdefault_params(molc, "prrn")
    mtx, _ = jscoring.build_matrix(molc, params)
    seqs = [jab.encode(r.seq.replace("-", ""), molc) for r in recs]
    want = jdistance.distance_matrix(seqs, mtx, u=params.u, v=params.v,
                                     sh=params.sh)
    got = distance.distance_matrix(seqs, mtx, u=params.u, v=params.v,
                                   sh=params.sh, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tj = jtree.upgma(want, len(seqs))
    tt = tree.upgma(got, len(seqs))
    for a, b in zip(_tree_fields(tt), _tree_fields(tj)):
        np.testing.assert_array_equal(a, b)


def test_copied_upgma_reproduces_tree_fixture7():
    golden = json.loads((FIX / "tree_fixture7.json").read_text())
    t = tree.upgma(np.array(golden["dist"]), golden["n"])
    for i, nd in enumerate(golden["nodes"]):
        assert (t.left[i] if t.left[i] >= 0 else -1) == nd["left"]
        assert (t.right[i] if t.right[i] >= 0 else -1) == nd["right"]
        np.testing.assert_allclose(t.height[i], nd["height"], rtol=1e-5,
                                   atol=1e-6)
        assert t.ndesc[i] == nd["ndesc"]
    np.testing.assert_allclose(tree.calc_seq_weights(t), golden["calcwt"],
                               rtol=1e-5, atol=1e-6)
