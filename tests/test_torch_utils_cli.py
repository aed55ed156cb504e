"""The port's utility programs (``phyln``, ``iden``, ``decomp``,
``makmdm``, ``makdbs``, ``rdn``, ``utn``, ``utp``) against the JAX
package's, live on the CPU, on every run of ``chip_smoke.utils_cases``
(phase 15 holds the card to the same runs): standard output and error
byte for byte, and the bytes of every file a program writes.  Also the
C++ goldens of ``iden``, and the copied modules (``utils/resite``,
``utils/prosite``, ``ops/pairwise_np``) on the cases of the JAX
package's own tests."""

import contextlib
import dataclasses
import io as _io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import cli as jcli, scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JAlnParams
from prrn_aln_tpu.ops import pairwise_np as jpairwise_np
from prrn_aln_tpu.utils import prosite as jprosite, resite as jresite
from prrn_aln_tpu_torch import cli, io as tio
from prrn_aln_tpu_torch.native import SeqDB
from prrn_aln_tpu_torch.ops import pairwise_np
from prrn_aln_tpu_torch.ops.window import stripe
from prrn_aln_tpu_torch.utils import prosite, resite

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import run_util, utils_cases, write_utils_inputs  # noqa: E402

CASES = utils_cases()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The runs' input directory (``chip_smoke.write_utils_inputs``), the
    aligned ce13a17 being the port's ``prrn -R 0 -I 0`` output."""
    root = tmp_path_factory.mktemp("utils")
    aligned = root / "aligned.txt"
    with contextlib.redirect_stdout(_io.StringIO()):
        assert cli.prrn_main(["-R", "0", "-I", "0", "-o", str(aligned),
                              str(FIX / "ce13a17_clean.fa"),
                              "--device", "cpu"]) == 0
    write_utils_inputs(root, aligned)
    return root


@pytest.mark.parametrize("name", list(CASES))
def test_program_equals_jax(name, inputs):
    """Standard output, standard error and every file written, byte for
    byte (``phyln`` with ``--device cpu``: K1's plain version)."""
    prog, argv = CASES[name]
    port_argv = [*argv, "--device", "cpu"] if prog == "phyln" else argv
    got = run_util(getattr(cli, f"{prog}_main"), port_argv,
                   inputs / f"port_{name}")
    want = run_util(getattr(jcli, f"{prog}_main"), argv,
                    inputs / f"jax_{name}")
    assert got == want
    assert got["stdout"] or got["files"]
    if prog == "phyln":
        assert got["stdout"].endswith(";\n")


@pytest.mark.parametrize("name, golden", [("iden_dna", "idn_dna.txt"),
                                          ("iden_pro", "idn_pro.txt")])
def test_iden_equals_reference_golden(name, golden, inputs):
    prog, argv = CASES[name]
    got = run_util(cli.iden_main, argv, inputs / f"golden_{name}")
    assert got["stdout"] == (FIX / golden).read_text()


def test_iden_score_mode(inputs):
    got = run_util(cli.iden_main, CASES["iden_O0"][1], inputs / "O0")
    assert got["stdout"].split() == ["seqA", "seqB", "7"]


def test_makdbs_reads_back(inputs):
    run_util(cli.makdbs_main, CASES["makdbs"][1], inputs / "db")
    db = SeqDB(inputs / "db" / "db")
    recs = tio.sniff_and_read(FIX / "dnafam.fa")
    assert len(db) == len(recs) == 6
    assert db.names == [r.name for r in recs]
    assert [len(db[i]) for i in range(len(db))] == [len(r.seq) for r in recs]


def test_phyln_refuses_absent_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.phyln_main([str(FIX / "dnafam.fa")])


# the cases of tests/test_resite.py, held against the copied module


def test_resite_table_loads():
    enz = resite.load_enzymes()
    assert ([dataclasses.astuple(e) for e in enz]
            == [dataclasses.astuple(e) for e in jresite.load_enzymes()])
    assert len(enz) > 300
    eco = resite.find_enzyme("EcoRI", enz)
    assert eco is not None and eco.pattern == "GAATTC" and eco.cut == 2


def test_resite_table_from_aln_tab(tmp_path, monkeypatch):
    (tmp_path / "renzyme").write_text("MyEnz GGATCC 1\n")
    monkeypatch.setenv("ALN_TAB", str(tmp_path))
    assert resite._table_path() == jresite._table_path()
    assert [e.name for e in resite.load_enzymes()] == ["MyEnz"]


@pytest.mark.parametrize("seq,pat,want", [
    ("AAGAATTCTTGGAATTCA", "GAATTC", [2, 11]),
    ("TTGTATACTT", "GTMKAC", [2]),
    ("TTGTCGACTT", "GTMKAC", [2]),
    ("TTGTTAACTT", "GTMKAC", []),
    ("GANTTC", "GAATTC", []),
    ("GARTTC", "GARTTC", [0]),
])
def test_resite_positions(seq, pat, want):
    assert resite.pattern_positions(seq, pat) == want
    assert jresite.pattern_positions(seq, pat) == want


def test_resite_all_sites():
    seq = "AAGGCCTT" * 3
    hits = resite.all_sites(seq, 1)
    assert ([(dataclasses.astuple(e), locs) for e, locs in hits]
            == [(dataclasses.astuple(e), locs)
                for e, locs in jresite.all_sites(seq, 1)])
    pats = [e.pattern for e, _ in hits]
    assert all(a != b for a, b in zip(pats, pats[1:]))
    assert any(e.pattern == "AGGCCT" for e, _ in hits)


# the cases of tests/test_prosite.py, held against the copied module


@pytest.mark.parametrize("seq,pat,want", [
    ("ASARTKAA", "[ST]-x-[RK].", [(1, 4)]),
    ("ASARSKKA", "[ST]-x-[RK].", [(1, 4), (4, 7)]),
    ("ANASAA", "N-{P}-[ST]-{P}.", [(1, 5)]),
    ("ANPSAA", "N-{P}-[ST]-{P}.", []),
    ("MNVTK", "N-{P}-[ST]-{P}.", [(1, 5)]),
    ("MAAAK", "<M-A(2,3)-K.", [(0, 5)]),
    ("XMAAK", "<M-A(2,3)-K.", []),
    ("CAAK", "C-A(2)-K>.", [(0, 4)]),
    ("CAAKX", "C-A(2)-K>.", []),
    ("SSRR", "[ST]-x-[RK].", [(0, 3), (1, 4)]),
])
def test_prosite_scan(seq, pat, want):
    assert prosite.scan(seq, pat) == want
    assert jprosite.scan(seq, pat) == want


def test_prosite_parse_dat(inputs):
    dat = str(inputs / "in" / "prosite.dat")
    recs = list(prosite.parse_dat(dat))
    assert recs == list(jprosite.parse_dat(dat))
    assert recs[0] == ("PKC_PHOSPHO_SITE", "PS00005", "[ST]-x-[RK].")


# ops/pairwise_np, the f64 oracle, against the JAX package's copy

PW = json.loads((FIX / "pairwise_fixtures.json").read_text())


@pytest.mark.parametrize("case", PW["cases"][::4],
                         ids=lambda c: f"{c['a']}-{c['b']}-lcl{c['lcl']}")
def test_pairwise_np_equals_jax(case):
    a = np.array(PW["seqs"][case["a"]]["codes"], dtype=np.int64)
    b = np.array(PW["seqs"][case["b"]]["codes"], dtype=np.int64)
    if PW["seqs"][case["a"]]["molc"] == 1:
        mtx, _ = jscoring.protein_matrix(
            JAlnParams(pam=PW["matrices"]["protein_pam"]))
    else:
        mtx, _ = jscoring.dna_matrix(JAlnParams(
            u=PW["matrices"]["dna_u"],
            n_mismatch=PW["matrices"]["dna_mismatch"]))
    lcl = case["lcl"]
    kw = dict(u=case["u"], v=case["v"], tgapf=case["tgapf"],
              exgl_a=bool(lcl & 1), exgr_a=bool(lcl & 2),
              exgl_b=bool(lcl & 4), exgr_b=bool(lcl & 8),
              local=bool(lcl & 16))
    got = pairwise_np.pairwise_score_np(a, b, mtx,
                                        wdw=stripe(len(a), len(b),
                                                   case["sh"]), **kw)
    from prrn_aln_tpu.ops.window import stripe as jstripe
    want = jpairwise_np.pairwise_score_np(a, b, mtx,
                                          wdw=jstripe(len(a), len(b),
                                                      case["sh"]), **kw)
    assert got == want
    assert got == pytest.approx(case["score"], rel=2e-5, abs=0.05)


def test_programs_run_without_jax(tmp_path):
    """With ``jax`` and ``prrn_aln_tpu`` made unimportable, the programs
    run: ``utn -z`` reads the enzyme table from the JAX package's data
    directory as a file, ``phyln`` scores on K1's plain version."""
    import subprocess
    dna = str(FIX / "dnafam.fa")
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'prrn_aln_tpu'):\n"
            "            raise ModuleNotFoundError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from prrn_aln_tpu_torch import cli\n"
            f"cli.utn_main(['-z', 'EcoRI,HaeIII', {dna!r}])\n"
            f"cli.phyln_main(['-m', 'nj', {dna!r}, '--device', 'cpu'])\n"
            f"cli.makdbs_main([{dna!r}, '-b', {str(tmp_path / 'db')!r}])\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=FIX.parent.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    want = "".join(run_util(getattr(jcli, f"{prog}_main"), argv,
                            tmp_path / name)["stdout"]
                   for name, (prog, argv) in (
                       ("utn", ("utn", ["-z", "EcoRI,HaeIII", dna])),
                       ("phyln", ("phyln", ["-m", "nj", dna]))))
    assert res.stdout.startswith(want)
    assert res.stdout.endswith(f"6 entries -> {tmp_path / 'db'}"
                               ".psq/.pix/.pnm\n")
