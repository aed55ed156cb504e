#!/usr/bin/env python3
"""Time kernel K2 (the group wavefront, ``csrc/group_wavefront.cu``) on
seeded shapes of the port's main paths, on one CUDA card.

Run from the repository root:

    python3 tools/k2_bench.py                  # time, held to the plain version
    python3 tools/k2_bench.py --root DIR       # the port of another checkout
    python3 tools/k2_bench.py --ablate crg     # a step without its crg sums

Shapes (random gapped, weighted protein groups from a fixed seed):

- ``bench``: 32 pairs of 8 x 384 members x columns, all members real;
- ``merge7``: one progressive merge as ``prrn`` pads it below 16
  sequences: 3 + 4 real members of ~520 columns, sides padded to 7;
- ``merge6x1``: ce13a17's last progressive merge: a profile of 6
  members against one sequence, ~520 columns, sides padded to 7;
- ``refine19``: one refinement candidate of a 19-member family: 9 + 10
  real members of 172 and 526 columns, sides padded to 19.

``--root`` imports ``prrn_aln_tpu_torch`` from another checkout (an
unpacked parent commit), so two kernels are compared in one run on one
card.  ``--ablate`` cuts a loop of the kernel to no iterations in a copy
of the sources under ``build/`` (``crg``: the member-pair sums;
``chan``: the channel sums of the profile scores; ``runs``: the gap-run
updates; ``all``: the three): the output is then wrong and is not
checked; the time says what the part costs a step.  ``--no-check``
skips the plain version.

Each checked kernel call is held to the plain version once, bit for bit;
then prints one JSON line a shape: the median of warm calls (CUDA
events), microseconds a step, real and padded member pairs and the
variant.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
# loops of the kernel an ablation cuts to no iterations
ABLATIONS = {
    "crg": ["for (int i = 0; i < R.an; ++i) {"],
    "chan": ["for (int c = 0; c < C; ++c)"],
    "runs": ["for (int i = 0; i < an_b; ++i) {",
             "for (int j = 0; j < bn_b; ++j) {"],
}
ABLATIONS["all"] = [x for v in ABLATIONS.values() for x in v]


def rand_msa(ab, Msa, mtx, rng, many: int, L: int):
    codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < 0.08] = ab.GAP
    codes[:, 0] = ab.ALA + rng.integers(0, 20)
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)],
            weight=rng.random(many) + 0.5)
    m.prepare(mtx.shape[0])
    return m


def shape_pairs(name: str, new):
    """Pairs, member pad, length pad of a shape."""
    if name == "bench":
        return [(new(8, 384), new(8, 384)) for _ in range(32)], 8, 384
    if name == "merge7":
        return [(new(3, 518), new(4, 520))], 7, 1040
    if name == "merge6x1":
        return [(new(6, 525), new(1, 519))], 7, 1040
    return [(new(9, 172), new(10, 526))], 19, 560


def shape_inputs(name: str, dev, G, ab, Msa, mtx, stripe):
    """Packed K2 inputs and launch sizes of a shape."""
    rng = np.random.default_rng(0)
    pairs, pad, len_pad = shape_pairs(
        name, lambda many, L: rand_msa(ab, Msa, mtx, rng, many, L))
    la_max = lb_max = G._bucket(max([len_pad] + [max(A.length, B.length)
                                                 for A, B in pairs]))
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    nslot = G._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    nsteps = G._bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    items = [G._pack_inputs(A, B, mtx, 2.0, 9.0, w, pad, pad, la_max,
                            lb_max, spb=20.0)
             for (A, B), w in zip(pairs, wd)]
    return G.stack_inputs(items, dev), dict(nslot=nslot, nsteps=nsteps)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ablated_sources(root: Path, part: str) -> Path:
    """A copy of the kernel sources with the loops of ``part`` cut."""
    out = REPO / "build" / f"k2_ablate_{part}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / "prrn_aln_tpu_torch" / "csrc", out)
    src = out / "group_wavefront.cu"
    text = src.read_text()
    for loop in ABLATIONS[part]:
        if loop not in text:
            raise ValueError(f"no loop {loop!r} in {src}")
        text = text.replace(loop, loop.replace("; ++", " && false; ++"))
    src.write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_bench: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from prrn_aln_tpu_torch import alphabet as ab, scoring
    from prrn_aln_tpu_torch.config import AlnParams
    from prrn_aln_tpu_torch.msa.msa import Msa
    from prrn_aln_tpu_torch.ops import _build, group as G
    from prrn_aln_tpu_torch.ops.window import stripe
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    check = not (args.no_check or args.ablate)
    if args.ablate:
        _build._CSRC = ablated_sources(root, args.ablate)
        _build._BUILD = REPO / "build" / f"k2_ablate_{args.ablate}_lib"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name in ("bench", "merge7", "merge6x1", "refine19"):
        ins, kw = shape_inputs(name, dev, G, ab, Msa, mtx, stripe)
        if check:
            got = G.group_wavefront(ins, **kw)
            ref = G.group_wavefront_ref(ins, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3])):
                raise AssertionError(f"K2 != plain on {name}")
        ms = time_ms(lambda: G.group_wavefront(ins, **kw), 7)
        real = ((ins["wa"] != 0).sum(1) * (ins["wb"] != 0).sum(1)).max()
        plan = (G.wavefront_plan(ins, nslot=kw["nslot"])
                if hasattr(G, "wavefront_plan") else {"variant": "one"})
        print(json.dumps({"shape": name, "root": str(root), "ms": ms,
                          "us_per_step": ms * 1e3 / kw["nsteps"],
                          "nslot": kw["nslot"], "nsteps": kw["nsteps"],
                          "real_member_pairs": int(real),
                          "padded_member_pairs": ins["wa"].shape[1]
                          * ins["wb"].shape[1],
                          "variant": plan["variant"],
                          "ablate": args.ablate, "checked": check}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
