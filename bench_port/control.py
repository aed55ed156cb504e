"""The comparison's control at the cell's own size: the plain reference
put in the program's place and computed one float step lower
(``prrn_ref.precision.lowered``: float32 for float64, bfloat16 for
float32, on the reference's PyTorch K2), judged as a run judges the
program.

    python bench_port/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, the families a run with that seed compares (those of the
window that its check draws, every family of the pool being done, and
its fresh families), each aligned three ways: the reference, the
reference on the control's engine at the stated precision
(``precision.torch_k2``), and the control.  Printed for each family:
``engines_differ``, the rows in which the second differs from the first
(0: the control's engine is the reference's at this size, so what the
control changes is its precision alone), and ``rows_differ``, those in
which the control does; then, for each seed, the ``rows_differ`` that a
run compares beside its limit (0).  A sound control reads above the
limit on every seed.  Host only; ``--workers`` processes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def main(argv=None) -> int:
    import numpy as np
    from harness import check, families as fam, load
    from harness.reference import MODES, references
    import run as bench

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    cell, tr, config, _ = bench.load_cell(args.workload)
    drv = load("traffic", cell["traffic"])
    made = fam.pool([tr["pool_seed"], drv.POOL], config, tr["pool"])
    # the families each seed compares, by key
    fams = {("pool", k): f for k, f in enumerate(made)}
    per_seed = {}
    for seed in args.seeds:
        seed %= 2 ** 64
        rng = np.random.default_rng([seed, 3])
        keys = [("pool", int(k)) for k in sorted(rng.choice(
            len(made), min(tr["checked"], len(made)), replace=False))]
        shapes = np.random.default_rng([seed, 4]).choice(
            len(tr["pool"]), tr["fresh"]).tolist()
        for k, f in enumerate(fam.pool([tr["pool_seed"], drv.FRESH, seed],
                                       config,
                                       [tr["pool"][i] for i in shapes])):
            fams[(seed, k)] = f
            keys.append((seed, k))
        per_seed[seed] = keys
    order = list(fams)
    rows = references([(config["reference"], fams[key].names,
                        fams[key].seqs, mode)
                       for key in order for mode in MODES], args.workers)
    differ = {}
    for i, key in enumerate(order):
        ref, low, eng = rows[3 * i:3 * i + 3]
        differ[key] = check.rows_differ(low, ref)
        print(json.dumps({"family": list(key), "sequences":
                          len(fams[key].seqs), "residues":
                          fams[key].residues, "engines_differ":
                          check.rows_differ(eng, ref),
                          "rows_differ": differ[key]}), flush=True)
    for seed, keys in per_seed.items():
        print(json.dumps({"seed": seed, "rows_differ": sum(
            differ[k] for k in keys), "limit": 0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
