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
            "assert 'prrn_aln_tpu_torch.cli' in mods, mods\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'prrn_aln_tpu'"
            " or m.startswith('prrn_aln_tpu.')]\n"
            "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert res.stdout.strip() == ""
