"""The benchmark's harness: traffic generation, tracing, the work a
kernel needs, and the comparison that decides ``correct``.  Imports
nothing of the program (``prrn_aln_tpu_torch``) at module level.

What belongs to one traffic mix, one family generator, one kernel or one
metric sits in a file of its own, ``bench_port/<kind>/<name>.py``, found
by the name that ``BENCHMARK.json`` or a configuration gives it.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def load(kind: str, name: str):
    """The module ``bench_port/<kind>/<name>.py``, loaded once."""
    key = f"bench_port_{kind}_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, BENCH / kind / f"{name}.py")
        if spec is None or not spec.loader:
            raise SystemExit(f"no {kind} named {name!r}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def names(kind: str) -> list[str]:
    """The names of every file of ``bench_port/<kind>/``, in order."""
    return sorted(p.stem for p in (BENCH / kind).glob("*.py"))
