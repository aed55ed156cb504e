"""The port's prrn main path (plain versions on the CPU) vs the JAX
package: byte-identical stdout on a small slice of the flagship family,
and identical refinement from a state handed across mid-pipeline."""

import contextlib
import dataclasses
import io as _io
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, io as jio, scoring as jscoring
from prrn_aln_tpu.cli import prrn_main as jax_prrn_main
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.msa import tree as jtree
from prrn_aln_tpu.msa.msa import single as jsingle
from prrn_aln_tpu.msa.progressive import progressive_msa as jprogressive
from prrn_aln_tpu.msa.refine import refine_with_consreg as jrefine
from prrn_aln_tpu.utils.crand import GlibcRand as JGlibcRand
from prrn_aln_tpu_torch import convert
from prrn_aln_tpu_torch.cli import prrn_main
from prrn_aln_tpu_torch.msa.refine import refine_with_consreg
from prrn_aln_tpu_torch.utils.crand import GlibcRand

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def slice5(tmp_path_factory):
    """First 5 sequences of ce13a17_clean.fa cut to 120 residues."""
    recs = jio.read_fasta(FIX / "ce13a17_clean.fa")[:5]
    path = tmp_path_factory.mktemp("slice") / "slice5.fa"
    path.write_text("".join(f">{r.name}\n{r.seq[:120]}\n" for r in recs))
    return path


def _stdout(main, argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("seed", ["0", "1"])
def test_prrn_stdout_matches_jax(slice5, seed):
    want = _stdout(jax_prrn_main, ["-R", seed, str(slice5)])
    got = _stdout(prrn_main, ["-R", seed, str(slice5), "--device", "cpu"])
    assert got == want


def test_refinement_from_jax_state_matches(slice5):
    """The JAX package's progressive MSA, handed across with convert, is
    refined to the same rows by both packages."""
    recs = jio.read_fasta(slice5)
    molc = jab.infer_molc(recs[0].seq)
    jparams = jdefault_params(molc, "prrn")
    mtx, _ = jscoring.build_matrix(molc, jparams)
    seqs = [jab.encode(r.seq, molc) for r in recs]
    from prrn_aln_tpu.msa import distance as jdistance
    d = jdistance.distance_matrix(seqs, mtx, u=jparams.u, v=jparams.v,
                                  sh=jparams.sh)
    t = jtree.upgma(d, len(seqs))
    leaves = [jsingle(s, molc, r.name) for s, r in zip(seqs, recs)]
    mid = jprogressive(leaves, t, mtx, u=jparams.u, v=jparams.v,
                       sh=jparams.sh, spb=jparams.spb)
    params = convert.params_from_numpy(dataclasses.asdict(jparams))
    assert params == type(params)(**dataclasses.asdict(jparams))
    port_mid = convert.msa_from_numpy(mid.codes, mid.weight, mid.names,
                                      mid.molc, mid.eij)
    kw = dict(u=params.u, v=params.v, sh=params.sh, maxitr=10, randseed=1,
              spb=params.spb)
    want = jrefine(mid, mtx, crand=JGlibcRand(1), **kw).msa
    got = refine_with_consreg(port_mid, mtx, crand=GlibcRand(1),
                              device="cpu", **kw).msa
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.names == want.names


def test_cli_rejects_unported_flags(slice5, tmp_path):
    """``-U``, which once exited "not yet ported": a pre-aligned host (4
    members aligned by the JAX package) and an unaligned guest, cut in
    and refined, byte-identical to the JAX CLI."""
    aligned = _stdout(jax_prrn_main, ["-R", "0", "-I", "0", str(slice5)])
    native = tmp_path / "aligned.txt"
    native.write_text(aligned)
    recs = jio.sniff_and_read(native)
    host, guest = tmp_path / "host.fa", tmp_path / "guest.fa"
    host.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs[:4]))
    guest.write_text(f">{recs[4].name}\n{recs[4].seq.replace('-', '')}\n")
    argv = ["-U", "-R", "0", str(host), str(guest)]
    got = _stdout(prrn_main, [*argv, "--device", "cpu"])
    assert got == _stdout(jax_prrn_main, argv)
    assert got.count(recs[4].name) >= 2


def test_cli_cuda_absent_raises(slice5):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prrn_main([str(slice5)])
