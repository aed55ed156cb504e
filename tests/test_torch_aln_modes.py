"""The port's ``aln`` pair, group and utility modes, plain versions on
the CPU, against the JAX package's CLI: the group merge of Multi_A x
Multi_B (byte-identical to the reference's ``golden_aln_multiAB.txt``),
``-F``, ``-M``, ``-L s``/``-C``, ``-R``, ``-a``, ``-i``, ``-m`` and the
long-gap (``ls=3``) group pair.

``jax_aln_R10_idn.txt`` and ``jax_align_pair_ls3_multiAB.txt`` were
written by the JAX package (``tools/write_jax_fixtures.py``); the latter
through its accelerator branch (``group_align``, f32), which the port's
K2 follows on the card."""

import contextlib
import io as _io
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, io as jio, scoring as jscoring
from prrn_aln_tpu.cli import aln_main as jax_aln_main
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.msa.progressive import align_pair as jalign_pair
from prrn_aln_tpu_torch import alphabet as ab, io as pio, scoring
from prrn_aln_tpu_torch.cli import aln_main
from prrn_aln_tpu_torch.config import default_params
from prrn_aln_tpu_torch.msa.merge import merge_msas
from prrn_aln_tpu_torch.msa.progressive import align_pair, select_swap
from prrn_aln_tpu_torch.ops.group import group_align
from prrn_aln_tpu_torch.ops.window import stripe

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _run(main, argv):
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


def _both(argv):
    """(port, JAX) standard output and error of aln on ``argv``."""
    return _run(aln_main, [*argv, "--device", "cpu"]), _run(jax_aln_main,
                                                            argv)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """Multi_A and Multi_B rebuilt from the galign fixture, as
    tests/test_cli.py does."""
    tmp = tmp_path_factory.mktemp("multi")
    gfix = json.loads((FIX / "galign_fixtures.json").read_text())
    paths = []
    for key in ("pas/Multi_A", "pas/Multi_B"):
        info = gfix["files"][key]
        p = tmp / key.split("/")[-1]
        with open(p, "w") as f:
            f.write(f"{len(info['rows']):5d}{len(info['rows'][0]):6d}\tx\n")
            for n, r in zip(info["names"], info["rows"]):
                f.write(f">{n}\n{r}\n/\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("fmt", ["native", "fasta", "clustal"])
def test_group_pair_matches_jax(multi, fmt, tmp_path):
    """The group merge through ``-o`` (native: the reference's bytes) and
    each ``-F``; the ``; Score`` line on stderr."""
    out = tmp_path / "out.txt"
    got = _run(aln_main, [*multi, "-F", fmt, "-o", str(out),
                          "--device", "cpu"])
    text = out.read_text()
    want = _run(jax_aln_main, [*multi, "-F", fmt, "-o", str(out)])
    assert got == want == ("", "; Score = 86.3\n")
    assert text == out.read_text()
    if fmt == "native":
        assert text == (FIX / "golden_aln_multiAB.txt").read_text()


def test_both_strands_match_jax(tmp_path):
    """``-M``: the second input's reverse complement scores higher."""
    random.seed(5)
    s = "".join(random.choice("ACGT") for _ in range(120))
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    (tmp_path / "x.fa").write_text(">x\n" + s + "\n")
    (tmp_path / "y.fa").write_text(
        ">y\n" + "".join(comp[c] for c in reversed(s[7:110])) + "\n")
    got, want = _both(["-M", str(tmp_path / "x.fa"), str(tmp_path / "y.fa")])
    assert got == want
    assert "(strand -)" in got[1]


@pytest.mark.parametrize("flags, golden", [
    (["-Ls"], "loc_single.txt"),
    (["-Ls", "-C", "4", "-w", "300"], "loc_multi.txt"),
    (["-Ls", "-C", "2"], None),
])
def test_local_colonies_match_jax(flags, golden):
    got, want = _both([*flags, str(FIX / "loc_a.fa"), str(FIX / "loc_b.fa")])
    assert got == want
    if golden:
        assert got[0] == (FIX / golden).read_text()


def test_shuffle_test_matches_jax_fixture():
    """``-R 10``: the 11 scores in one K1 batch; the printed Z-score,
    mean and SD equal the JAX package's, then the pair's alignment."""
    got, _ = _run(aln_main, ["-R", "10", str(FIX / "idn_p.fa"),
                             str(FIX / "idn_q.fa"), "--device", "cpu"])
    want = (FIX / "jax_aln_R10_idn.txt").read_text()
    assert got == want
    assert got.startswith("Dev = ") and "(10 jumbles)" in got


def test_shuffle_test_under_the_row_sweep_switch(monkeypatch):
    """``PRRN_PW_FUSED=1`` does not reach the shuffle test: the JAX
    function calls the scan scorer, so the port keeps K1."""
    monkeypatch.setenv("PRRN_PW_FUSED", "1")
    argv = ["-R", "3", str(FIX / "idn_p.fa"), str(FIX / "idn_q.fa")]
    got, want = _both(argv)
    assert got == want


@pytest.fixture(scope="module")
def three_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("three")
    seqs = {"s1": "MKVLWAAGLFDERT", "s2": "MKVLWAGLFDERS",
            "s3": "MRVLWAAGIFDQRT", "s4": "MKILWAAGLF"}
    files = []
    for n, s in seqs.items():
        f = tmp / f"{n}.fa"
        f.write_text(f">{n}\n{s}\n")
        files.append(str(f))
    return files


@pytest.mark.parametrize("fmt", ["native", "fasta"])
def test_pileup_matches_jax(three_files, fmt):
    got, want = _both(["-a", "-F", fmt, *three_files])
    assert got == want
    assert got[0].count("s") >= 4


@pytest.mark.parametrize("mode", ["e", "f", "l", "p", "i", "a", "catalog"])
def test_catalog_modes_match_jax(three_files, mode, tmp_path):
    both = tmp_path / "all.fa"
    both.write_text("".join(Path(f).read_text() for f in three_files))
    if mode == "catalog":
        cat = tmp_path / "cat.txt"
        cat.write_text("# the inputs\n" + "\n".join(three_files) + "\n")
        argv = ["-i", f"e:{cat}"]
    else:
        argv = ["-i", mode, str(both)]
    got, want = _both(argv)
    assert got == want
    npair = {"e": 6, "f": 3, "l": 3, "p": 2, "i": 4, "a": 2, "catalog": 6}
    assert got[0].count("! ") == npair[mode]


def test_matrix_file_matches_jax(tmp_path):
    """``-m``: a BLAST-layout exchange matrix that the test writes
    (seeded integers, symmetric) replaces the PAM matrix."""
    aa = "ARNDCQEGHILKMFPSTWYV"
    rng = np.random.default_rng(4)
    m = rng.integers(-4, 3, (20, 20))
    m = np.triu(m) + np.triu(m, 1).T
    np.fill_diagonal(m, rng.integers(4, 12, 20))
    lines = ["# seeded test matrix", "   " + "  ".join(aa)]
    lines += [c + " " + " ".join(f"{x:2d}" for x in row)
              for c, row in zip(aa, m)]
    mfile = tmp_path / "seeded.mat"
    mfile.write_text("\n".join(lines) + "\n")
    argv = ["-m", str(mfile), str(FIX / "idn_p.fa"), str(FIX / "idn_q.fa")]
    got, want = _both(argv)
    assert got == want
    plain, _ = _both(argv[2:])
    assert got[1] != plain[1]                # another score


def _ls3_groups(multi, pkg_io, pkg_ab):
    return [pkg_io.records_to_msa(pkg_io.sniff_and_read(p), pkg_ab.PROTEIN)
            for p in multi]


def test_ls3_pair_on_the_cpu_matches_jax(multi):
    """``align_pair(ls=3)`` on the CPU takes the host aligner
    (``group_align_np``, f64) in both packages: the same score, SKL and
    merged rows."""
    jA, jB = _ls3_groups(multi, jio, jab)
    jparams = jdefault_params(jab.PROTEIN, "aln")
    jmtx, _ = jscoring.build_matrix(jab.PROTEIN, jparams)
    want = jalign_pair(jA, jB, jmtx, u=jparams.u, v=jparams.v,
                       sh=jparams.sh, ls=3)
    A, B = _ls3_groups(multi, pio, ab)
    params = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    got = align_pair(A, B, mtx, u=params.u, v=params.v, sh=params.sh, ls=3,
                     device="cpu")
    assert got[0] == want[0] and got[2] == want[2]
    assert [tuple(k) for k in got[1]] == [tuple(k) for k in want[1]]
    assert (pio.write_native_block(merge_msas(A, B, got[1]))
            == jio.write_native_block(merge_msas(jA, jB, want[1])))


def test_ls3_pair_accelerator_branch_matches_jax_fixture(multi):
    """What ``align_pair(ls=3)`` runs on the card, K2's plain version
    (``group_align``, f32) here: the JAX accelerator branch's score bits,
    swap, SKL and merged rows."""
    head, _, block = (FIX / "jax_align_pair_ls3_multiAB.txt").read_text() \
        .partition("\nskl ")
    skl_line, _, block = block.partition("\n")
    A, B = _ls3_groups(multi, pio, ab)
    params = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    swapped = select_swap(A, B)
    if swapped:
        A, B = B, A
    A.prepare(mtx.shape[0])
    B.prepare(mtx.shape[0])
    score, skl = group_align(A, B, mtx, u=params.u, v=params.v,
                             wdw=stripe(A.length, B.length, params.sh),
                             spb=params.spb, ls=3, device="cpu")
    assert head == f"score {score!r}\nswapped {swapped}"
    assert [list(map(int, k)) for k in skl] == json.loads(skl_line)
    assert pio.write_native_block(merge_msas(A, B, skl)) == block
