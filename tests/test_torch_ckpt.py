"""Refinement checkpoints across the two packages, plain versions on the
CPU: a checkpoint written by either package's ``prrn --ckpt`` holds the
same arrays, and ``prrn --resume`` of either package resumes it to the
same bytes.  ``jax_ckpt_ce13a17_I0.npz`` (``prrn -R 0 -I 0 --ckpt`` on
ce13a17_clean.fa) and ``jax_prrn_resume_ce13a17.txt`` (``prrn --resume``
of it) were written by the JAX package (``tools/write_jax_fixtures.py``).
"""

import contextlib
import io as _io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import io as jio
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


@pytest.fixture(scope="module")
def slice5(tmp_path_factory):
    """First 5 sequences of ce13a17_clean.fa cut to 120 residues."""
    recs = jio.read_fasta(FIX / "ce13a17_clean.fa")[:5]
    path = tmp_path_factory.mktemp("slice") / "slice5.fa"
    path.write_text("".join(f">{r.name}\n{r.seq[:120]}\n" for r in recs))
    return path


def _arrays(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


def test_checkpoints_agree_and_resume_across_packages(slice5, tmp_path):
    """``-R 0 -I 0 --ckpt``: both checkpoints hold the same codes,
    weights and metadata; each package's ``--resume`` of each checkpoint
    prints the same bytes.  ``-u 3`` is given to the resume and ignored
    there, as the JAX branch ignores it."""
    port_ck, jax_ck = tmp_path / "port.npz", tmp_path / "jax.npz"
    argv = ["-R", "0", "-I", "0", str(slice5)]
    out_p = _stdout(prrn_main, [*argv, "--ckpt", str(port_ck), "--device",
                                "cpu"])
    out_j = _stdout(jax_prrn_main, [*argv, "--ckpt", str(jax_ck)])
    assert out_p == out_j
    a, b = _arrays(port_ck), _arrays(jax_ck)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert json.loads(bytes(a["meta"]).decode())["randseed"] == 0
    resumed = {}
    for ck in (port_ck, jax_ck):
        resumed[ck.name] = (
            _stdout(prrn_main, ["--resume", str(ck), "-u", "3",
                                "--device", "cpu"]),
            _stdout(jax_prrn_main, ["--resume", str(ck), "-u", "3"]))
    assert len({t for pair in resumed.values() for t in pair}) == 1
    assert resumed["port.npz"][0] != out_p


def test_resume_from_jax_checkpoint_matches_jax_fixture(tmp_path):
    """The port resumes the JAX package's checkpoint of ce13a17 to the
    JAX package's bytes, and writes a checkpoint of the result that the
    JAX package reads back to the same MSA."""
    ck = tmp_path / "again.npz"
    got = _stdout(prrn_main, ["--resume", str(FIX / "jax_ckpt_ce13a17_I0.npz"),
                              "--ckpt", str(ck), "--device", "cpu"])
    assert got == (FIX / "jax_prrn_resume_ce13a17.txt").read_text()
    from prrn_aln_tpu.utils.runstat import load_checkpoint
    msa, meta = load_checkpoint(ck)
    assert jio.write_native_block(msa) == got
    assert meta["randseed"] == 0 and meta["iteration"] == 10
