"""The port imports neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and ``prrn_aln_tpu`` out of ``sys.modules``."""
    code = ("import importlib, pkgutil, sys\n"
            "import prrn_aln_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
            " pkg.__name__ + '.')]\n"
            "for name in mods:\n"
            "    importlib.import_module(name)\n"
            "for need in ('cli', 'ops.spliced_h', 'splice.hapi', 'native',"
            " 'msa.kmer', 'msa.slforest'):\n"
            "    assert 'prrn_aln_tpu_torch.' + need in mods, mods\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'prrn_aln_tpu'"
            " or m.startswith('prrn_aln_tpu.')]\n"
            "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert res.stdout.strip() == ""


def test_gene_prediction_runs_without_jax(tmp_path):
    """With ``jax`` and ``prrn_aln_tpu`` made unimportable, the port's
    ``aln -yl2`` runs on the CPU (an exon-only slice of the window)."""
    win = (ROOT / "tests" / "fixtures" / "cet10b9_win31401.fa").read_text()
    seq = "".join(win.splitlines()[1:])
    (tmp_path / "g.fa").write_text(">g\n" + seq[214:400] + "\n")
    pro = (ROOT / "tests" / "fixtures" / "ce13a1_unaligned.fa").read_text()
    (tmp_path / "p.fa").write_text(
        ">p\n" + "".join(pro.splitlines()[1:])[:60] + "\n")
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'prrn_aln_tpu'):\n"
            "            raise ModuleNotFoundError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from prrn_aln_tpu_torch.cli import aln_main\n"
            f"aln_main(['-yl2', '-O', '5', {str(tmp_path / 'g.fa')!r}, "
            f"{str(tmp_path / 'p.fa')!r}, '--device', 'cpu'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert res.stdout.startswith("#")


def test_forest_path_runs_without_jax(tmp_path):
    """With ``jax`` and ``prrn_aln_tpu`` made unimportable, the port's
    ``prrn`` takes the forest path on the CPU (16 short sequences in two
    families, no refinement)."""
    code = ("import sys\n"
            "import numpy as np\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'prrn_aln_tpu'):\n"
            "            raise ModuleNotFoundError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from prrn_aln_tpu_torch.cli import prrn_main\n"
            "rng = np.random.default_rng(2)\n"
            "aa = np.array(list('ACDEFGHIKLMNPQRSTVWY'))\n"
            "with open(sys.argv[1], 'w') as fh:\n"
            "    for f in range(2):\n"
            "        anc = aa[rng.integers(0, 20, 40 + 6 * f)]\n"
            "        for i in range(8):\n"
            "            s = anc.copy()\n"
            "            hit = rng.random(len(s)) < 0.1\n"
            "            s[hit] = aa[rng.integers(0, 20, hit.sum())]\n"
            "            fh.write(f'>f{f}s{i}\\n' + ''.join(s) + '\\n')\n"
            "sys.exit(prrn_main(['-R', '0', '-I', '0', sys.argv[1],"
            " '--device', 'cpu']))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "f.fa")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    assert res.stdout.count("| f0s") >= 8 and res.stdout.count("| f1s") >= 8
