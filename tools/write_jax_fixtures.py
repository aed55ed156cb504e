#!/usr/bin/env python3
"""Write the JAX package's output fixtures for the port's ``prrn`` and
``aln`` modes (update, guided, grouped, resumed, ``-e``, the ``-yl3``
group pair and ``aln -R``), with the JAX package on the CPU:

    JAX_PLATFORMS=cpu python3 tools/write_jax_fixtures.py [--only NAME ...]

Each fixture is the JAX CLI's standard output (or, for ``-e``, the files
it writes), byte for byte; ``tests/test_torch_*.py`` and ``chip_smoke.py``
hold the port to them.  The inputs are in ``tests/fixtures``; the
pre-aligned ones are written to a temporary directory by
``chip_smoke.write_cli_inputs``: Multi_A and Multi_B as
``tests/test_update.py`` writes them (from ``galign_fixtures.json``),
and ce13a17 from the rows of ``jax_prrn_ce13a17_clean_R0.txt``.

``jax_align_pair_ls3_multiAB.txt`` is ``align_pair(..., ls=3)`` on Multi_A
x Multi_B through the JAX package's accelerator branch
(``group_align``, the f32 wavefront): ``jax.default_backend`` is made to
answer "gpu" for that call only, so the package itself is unchanged.

The spliced fixtures come from the JAX package's f32 engines, which it
runs on an accelerator (on a CPU it picks the float64 oracle):
``jax_aln_G_gen{1,2}_<mode>.txt`` and ``jax_aln_yl2_mini_dna.txt`` are
``aln -G``/``-yl2`` with a DNA query, ``splice.api.spliced_align`` called
with ``engine="device"``; ``jax_aln_yl2_long_protein.txt`` is ``aln
-yl2`` on ``long_protein_{gen,pro}.fa`` (``chip_smoke.long_protein_gene``'s
lp2100, 2,101 rows) with ``splice.hapi.spliced_align_h`` called with
``engine="device"``: past 1,024 rows ``forward_h_device`` runs its scan
engine ``_sweep_h``, which K4 reproduces (~4 min on one core);
``jax_refgs_*.txt`` are ``refgs`` on the
family of ``chip_smoke.refgs_family_inputs`` with ``splice.hapi.spliced_align_h``
called with ``engine="device"``.  Both are wrapped for the run only;
``aln_main`` and ``refgs`` import them inside the function, so the wrap
takes effect without touching the package.

``jax_utils_cli.json`` holds the utility programs (``phyln``, ``iden``,
``decomp``, ``makmdm``, ``makdbs``, ``rdn``, ``utn``, ``utp``) on the
runs of ``chip_smoke.utils_cases``: each one's standard output and error
and the files it writes (hex).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io as _io
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"


def stdout_of(main, argv) -> str:
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise SystemExit(f"{argv}: exit {rc}")
    return buf.getvalue()


def ls3_pair_text(paths: list[str]) -> str:
    """``align_pair(ls=3)`` on the two groups through the accelerator
    branch: the score, the swap, the SKL and the merged rows."""
    import jax
    from prrn_aln_tpu import alphabet as ab, io, scoring
    from prrn_aln_tpu.config import default_params
    from prrn_aln_tpu.msa.merge import merge_msas
    from prrn_aln_tpu.msa.progressive import align_pair
    A, B = (io.records_to_msa(io.sniff_and_read(p), ab.PROTEIN)
            for p in paths)
    params = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    backend = jax.default_backend
    jax.default_backend = lambda: "gpu"
    try:
        score, skl, swapped = align_pair(A, B, mtx, u=params.u, v=params.v,
                                         sh=params.sh, ls=3)
    finally:
        jax.default_backend = backend
    if swapped:
        A, B = B, A
    merged = merge_msas(A, B, skl)
    return (f"score {score!r}\nswapped {swapped}\n"
            f"skl {json.dumps([list(map(int, k)) for k in skl])}\n"
            + io.write_native_block(merged))


# aln -G's modes: the fixtures' suffix and the flags
ALN_G_MODES = {"O0": ["-O", "0"], "O2": ["-O", "2"], "O3": ["-O", "3"],
               "O4": ["-O", "4"], "O5": ["-O", "5"], "default": []}
@contextlib.contextmanager
def f32_engines():
    """Route the JAX package's spliced aligners to their f32 engines."""
    from prrn_aln_tpu.splice import api, hapi
    real = api.spliced_align, hapi.spliced_align_h
    api.spliced_align = lambda *a, **k: real[0](*a, **k, engine="device")
    hapi.spliced_align_h = lambda *a, **k: real[1](*a, **k, engine="device")
    try:
        yield
    finally:
        api.spliced_align, hapi.spliced_align_h = real


def refgs_jobs(tmp: Path) -> dict:
    """The refgs fixtures' jobs: the family as annotated ("ok"), with
    ce13a1's second exon perturbed and the MSA rebuilt, and once through
    ``refgs_main`` (its output file and standard error)."""
    from chip_smoke import (REFGS_BAD, refgs_family_inputs, refgs_text,
                            write_refgs_inputs)
    from prrn_aln_tpu import refgs as rg
    from prrn_aln_tpu.cli import refgs_main
    from prrn_aln_tpu.io import SeqRecord
    g, fam = refgs_family_inputs()
    members = [SeqRecord(name, seq, exons=exons) for name, seq, exons in fam]

    def genome_of(name):
        return (g, 0) if name == "ce13a1" else None

    def ok():
        with f32_engines():
            return refgs_text(rg.refgs_family(members, genome_of, iters=2,
                                              rebuild=False))

    def perturbed():
        bad = [dataclasses.replace(members[0], exons=list(REFGS_BAD)),
               *members[1:]]
        with f32_engines():
            return refgs_text(rg.refgs_family(bad, genome_of, iters=2,
                                              rebuild=True))

    def cli():
        fam_path, gen = write_refgs_inputs(tmp, g, fam)
        out = tmp / "refgs_out.fa"
        err = _io.StringIO()
        with f32_engines(), contextlib.redirect_stderr(err):
            rc = refgs_main(["-n", gen, "-m", "ce13a1", "-I", "1", "-t",
                             str(out), "-pq", fam_path])
        if rc != 0:
            raise SystemExit(f"refgs_main: exit {rc}")
        return out.read_text() + "--- stderr\n" + err.getvalue()

    return {"jax_refgs_ok.txt": ok, "jax_refgs_perturbed.txt": perturbed,
            "jax_refgs_cli.txt": cli}


def utils_json() -> str:
    """``jax_utils_cli.json``: every run of ``chip_smoke.utils_cases``
    through the JAX package's program, its standard output and error and
    the files it writes, on the inputs ``chip_smoke.write_utils_inputs``
    lays out (the aligned ce13a17 is ``jax_prrn_ce13a17_clean_R0.txt``)."""
    from chip_smoke import run_util, utils_cases, write_utils_inputs
    from prrn_aln_tpu import cli

    tmp = Path(tempfile.mkdtemp(prefix="jaxutils"))
    write_utils_inputs(tmp, FIX / "jax_prrn_ce13a17_clean_R0.txt")
    out = {name: run_util(getattr(cli, f"{prog}_main"), argv, tmp / name)
           for name, (prog, argv) in utils_cases().items()}
    return json.dumps(out, indent=1, sort_keys=True) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="write only these fixtures (names as below)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GROUPS, write_cli_inputs
    from prrn_aln_tpu.cli import aln_main, prrn_main

    tmp = Path(tempfile.mkdtemp(prefix="jaxfix"))
    ins = write_cli_inputs(tmp)
    multi, ce_aln = ins["multi"], ins["ce13a17"]
    ckpt = FIX / "jax_ckpt_ce13a17_I0.npz"

    def guided(extra):
        here = os.getcwd()
        os.chdir(FIX)              # the tree's leaves are relative paths
        try:
            return stdout_of(prrn_main, ["-b", "guide5.nwk", *extra])
        finally:
            os.chdir(here)

    def fam19_dumps():
        prefix = tmp / "fam19_e"
        text = stdout_of(prrn_main, ["-R", "0", "-I", "0", "-e", str(prefix),
                                     str(FIX / "fam19.fa")])
        dumps = sorted(tmp.glob("fam19_e.*"),
                       key=lambda p: int(p.suffix[1:]))
        if text != dumps[0].read_text():
            raise SystemExit("-e: stdout differs from the first dump")
        for p in dumps:
            (FIX / f"jax_prrn_fam19_e_I0.{p.suffix[1:]}.txt").write_text(
                p.read_text())
        return None

    def resumed():
        stdout_of(prrn_main, ["-R", "0", "-I", "0", "--ckpt", str(ckpt),
                              str(FIX / "ce13a17_clean.fa")])
        return stdout_of(prrn_main, ["--resume", str(ckpt)])

    jobs = {
        "jax_prrn_U_R0_multiAB.txt":
            lambda: stdout_of(prrn_main, ["-U", "-R", "0", *multi]),
        "jax_prrn_guided5_R0.txt": lambda: guided(["-R", "0"]),
        "jax_prrn_G_ce13a17.txt":
            lambda: stdout_of(prrn_main, ["-R", "0", "-G", GROUPS, ce_aln]),
        "jax_prrn_resume_ce13a17.txt": resumed,
        "jax_prrn_fam19_e_I0": fam19_dumps,
        "jax_align_pair_ls3_multiAB.txt": lambda: ls3_pair_text(multi),
        "jax_aln_R10_idn.txt":
            lambda: stdout_of(aln_main, ["-R", "10", str(FIX / "idn_p.fa"),
                                         str(FIX / "idn_q.fa")]),
        **refgs_jobs(tmp),
        "jax_utils_cli.json": utils_json,
    }

    def aln_dna(argv):
        with f32_engines():
            return stdout_of(aln_main, argv)

    for case in (1, 2):
        for mode, flags in ALN_G_MODES.items():
            jobs[f"jax_aln_G_gen{case}_{mode}.txt"] = (
                lambda flags=flags, case=case: aln_dna(
                    ["-G", *flags, str(FIX / f"gen{case}.fa"),
                     str(FIX / f"cdna{case}.fa")]))
    mini = str(FIX / "mini_gen.fa")
    jobs["jax_aln_yl2_mini_dna.txt"] = lambda: aln_dna(["-yl2", mini, mini])
    # a protein past 1,024 rows: forward_h_device's scan engine (_sweep_h)
    jobs["jax_aln_yl2_long_protein.txt"] = lambda: aln_dna(
        ["-yl2", str(FIX / "long_protein_gen.fa"),
         str(FIX / "long_protein_pro.fa")])
    for name, job in jobs.items():
        if args.only and name not in args.only:
            continue
        text = job()
        if text is not None:
            (FIX / name).write_text(text)
        print(f"wrote {name}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
