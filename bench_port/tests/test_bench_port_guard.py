"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and the plain reference loads nothing of the program.  Names
are compared by their top-level part, whole: ``prrn_aln_tpu_torch`` is
not ``prrn_aln_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "prrn_aln_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "prrn_ref").rglob("*.py"):
        assert "prrn_aln_tpu_torch" not in top_level_imports(path), path


def loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split"
         "('.')[0] for m in sys.modules}))"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=600,
        check=True).stdout.strip().splitlines()[-1]
    return set(eval(out))


def test_a_run_loads_no_jax():
    mods = loaded_after(
        "import sys; sys.path[:0] = ['bench_port', '.']\n"
        "import run\n"
        "res = run.run_cell({'name': 't', 'chips': 1, 'traffic': "
        "'family_pool_passes'}, {'pool_seed': 1, 'pool': [[4, 40]], "
        "'checked': 1, 'fresh': 1}, {'generator': 'tree_family', "
        "'entry': {'call': 'prrn_aln_tpu_torch.cli:prrn_main', 'argv': "
        "['-R', '0', '--device', 'cpu', '-o', '{out}', '{fasta}']}, "
        "'reference': 'prrn_ref.pipeline:align_family', "
        "'family': {'identity': [0.2, 0.4], 'length_spread': 0.1, "
        "'inner_height': 0.8, 'indel_rate': 0.03, 'indel_max': 5}}, [], "
        "seed=1, seconds=0.01, trace=False, device='cpu')\n"
        "assert res['correct']\n"
        "import harness.tracing, harness.roofline\n"
        "from prrn_aln_tpu_torch import cli")
    assert "prrn_aln_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_after(
        "import sys; sys.path[:0] = ['bench_port']\n"
        "from prrn_ref.pipeline import align_family\n"
        "rows = align_family(['a', 'b', 'c'], ['MKVLAAGLLKW', 'MKVLAGLLKW',"
        " 'MRVLAAGLLRW'])\n"
        "assert len(rows) == 3")
    assert not mods & (FORBIDDEN | {"prrn_aln_tpu_torch"})
