#!/usr/bin/env python3
"""Where the wall of the port's ``prrn``/``aln`` modes goes, on one CUDA
card: each mode of ``chip_smoke.py``'s phase 13 (``cli_modes``) is run
once warm, then once under ``cProfile``, and its wall is split over the
functions that hold it.

Run from the repository root:

    python3 tools/cli_profile.py [--modes prrn_G,prrn_resume] [--top 8]

Modes: ``prrn_U`` (``prrn -U -R 0`` on Multi_A/B), ``prrn_guided``
(``prrn -b guide5.nwk -R 0``), ``prrn_G`` (``prrn -R 0 -G '1 2/3-5/6'``
on ce13a17 aligned), ``prrn_resume`` (``prrn --resume`` of
``jax_ckpt_ce13a17_I0.npz``), ``aln_multiAB`` and ``aln_R10``
(``aln -R 10`` on idn_p x idn_q).  Each output is held to its fixture,
as in ``chip_smoke.py``.

Prints the card and its power limit, then one JSON line a mode: the
warm wall (host clock around a run that ends in a synchronise), the
profiled wall, the kernel launches, the seconds (cumulative, profiled)
in each of ``score_path`` (the refinement's candidate scoring on the
host), ``group_align_np`` (the host group aligner), ``group_align``
(K2 and K3 with their packing) and the ``top`` functions by their own
time.  cProfile slows Python code, so its seconds are shares, not walls.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WATCH = {"score_path": ("path_score.py", "score_path"),
         "group_align_np": ("group_np.py", "group_align_np"),
         "group_align": ("group.py", "group_align")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="prrn_U,prrn_guided,prrn_G,"
                    "prrn_resume,aln_multiAB,aln_R10")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cli_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as C

    tmp = Path(tempfile.mkdtemp(prefix="cliprof"))
    ins = C.write_cli_inputs(tmp)
    fix, multi = C.FIX, ins["multi"]
    modes = {
        "prrn_U": (C.prrn_main, ["-U", "-R", "0", *multi],
                   "jax_prrn_U_R0_multiAB.txt"),
        "prrn_guided": (C.prrn_main, ["-b", str(fix / "guide5.nwk"), "-R",
                                      "0"], "jax_prrn_guided5_R0.txt"),
        "prrn_G": (C.prrn_main, ["-R", "0", "-G", C.GROUPS, ins["ce13a17"]],
                   "jax_prrn_G_ce13a17.txt"),
        "prrn_resume": (C.prrn_main,
                        ["--resume", str(fix / "jax_ckpt_ce13a17_I0.npz")],
                        "jax_prrn_resume_ce13a17.txt"),
        "aln_multiAB": (C.aln_main, multi, "golden_aln_multiAB.txt"),
        "aln_R10": (C.aln_main, ["-R", "10", str(fix / "idn_p.fa"),
                                 str(fix / "idn_q.fa")],
                    "jax_aln_R10_idn.txt"),
    }
    print(C.card_line(), flush=True)
    C._build.load()
    for name in args.modes.split(","):
        main_fn, argv_m, fixture = modes[name]
        text, secs, counts = C.run_cli(main_fn, argv_m)
        if text != (fix / fixture).read_text():
            raise AssertionError(f"{name}: output differs from {fixture}")
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        C.run_cli(main_fn, argv_m)
        prof.disable()
        psecs = time.perf_counter() - t0
        st = pstats.Stats(prof)
        watch = {k: 0.0 for k in WATCH}
        own = []
        for (fname, _, func), (_, _, tt, ct, _) in st.stats.items():
            for k, (f, fn) in WATCH.items():
                if func == fn and os.path.basename(fname) == f:
                    watch[k] += ct
            own.append((tt, f"{os.path.basename(fname)}:{func}"))
        own.sort(reverse=True)
        print(json.dumps({"mode": name, "seconds": secs,
                          "profiled_seconds": psecs, "launches": counts,
                          "cumulative": watch,
                          "top_own": [[f, t] for t, f in own[:args.top]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
