#!/usr/bin/env python3
"""Time kernel K6 (the band-frontier rows, ``csrc/frontier_sweep.cu``) on
one CUDA card: K6s under each plan (1, 2, 4 and 8 lanes a thread) on
seeded DNA pairs of 4,000 rows at several band widths, and K6r a row.

Run from the repository root:

    python3 tools/k6_bench.py                      # every width, every plan
    python3 tools/k6_bench.py --widths 520 --rows 4000

A width is the shard's lanes at world 1 (``W`` rounded up to 8): 520 is
``chip_smoke.py``'s 4 kb pair at band +-256.  Each plan's last H and G
are held bit for bit to the default plan's, which is held once to the
plain sweep on a pair cut to 64 rows.  Prints one JSON line a width:
each plan's time through the wrapper (CUDA events, median of warm
calls), its device time (``torch.profiler``), microseconds a row and
nanoseconds a row per warp; K6r's time a row through its wrapper and on
the device, on row ``rows // 2`` of the same pair with the values a
world-1 row receives.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from prrn_aln_tpu_torch import alphabet as ab, scoring  # noqa: E402
from prrn_aln_tpu_torch.config import default_params  # noqa: E402
from prrn_aln_tpu_torch.ops import _build, frontier as F  # noqa: E402


def events_ms(fn, reps: int) -> float:
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


def device_ms(fn, reps: int, word: str):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", 0) or 0
                for ev in prof.key_averages() if word in ev.key)
    return total / reps / 1e3 if total else None


def pair(Wl: int, rows: int, dev):
    """A seeded DNA sequence of ``rows`` and a mutant, the band centred,
    ``Wl`` lanes; the virtual row's H and G and the band on ``dev``."""
    rng = np.random.default_rng(4)
    params = default_params(ab.DNA, "prrn")
    mtx, _ = scoring.build_matrix(ab.DNA, params)
    codes = ab.encode("ACGT", ab.DNA)
    base = rng.integers(0, 4, rows)
    mut = np.where(rng.random(rows) < 0.03, rng.integers(0, 4, rows), base)
    lw, up = -(Wl // 2), Wl - Wl // 2 - 1
    H, G = F.row_init(0, Wl, lw, up, params.u, params.v, dev)
    band = tuple(torch.as_tensor(x, device=dev) for x in (
        codes[base].astype(np.int32), codes[mut].astype(np.int32),
        mtx.astype(np.float32)))
    return (H, G, *band), {"lw": lw, "W": up - lw + 1, "u": params.u,
                           "v": params.v}


def same(x, y) -> bool:
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32))
               for p, q in zip(x, y))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="64,520,1032,2056,4104,8192")
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load()
    for Wl in (int(w) for w in args.widths.split(",")):
        sargs, kw = pair(Wl, 64, dev)
        if not same(F.frontier_sweep(*sargs, **kw),
                    F.frontier_sweep_ref(*sargs, **kw)):
            raise AssertionError(f"K6s != the plain sweep at {Wl} lanes")
        sargs, kw = pair(Wl, args.rows, dev)
        want = F.frontier_sweep(*sargs, **kw)
        out = {"lanes": Wl, "rows": args.rows,
               "default": F.sweep_plan(Wl), "plans": {}}
        for k in F.K6S_LANES_A_THREAD:
            threads = -(-Wl // (32 * k)) * 32
            if threads > 1024:
                continue
            plan = {"kernel": "sweep", "k": k, "threads": threads}
            if not same(F.frontier_sweep(*sargs, plan=plan, **kw), want):
                raise AssertionError(f"plan {plan} differs at {Wl} lanes")
            ms = events_ms(lambda: F.frontier_sweep(*sargs, plan=plan, **kw),
                           args.reps)
            dms = device_ms(lambda: F.frontier_sweep(*sargs, plan=plan,
                                                     **kw), args.reps,
                            "frontier_sweep")
            out["plans"][k] = {
                "threads": threads, "ms": ms, "device_ms": dms,
                "us_a_row": 1e3 * (dms or ms) / args.rows,
                "ns_a_row_a_warp": 1e6 * (dms or ms) / args.rows
                / (threads // 32)}
        H, G, a, b, mtx = sargs
        m = args.rows // 2
        recv = (F.NEG_SENT, F.NEG_SENT, F.NEG_SENT, F.NEVSEL)
        rkw = {"m": m, "j0": 0, **kw}
        out["k6r"] = {
            "ms": events_ms(lambda: F.frontier_row(H, G, a, b, mtx, recv,
                                                   **rkw), 50),
            "device_ms": device_ms(lambda: F.frontier_row(
                H, G, a, b, mtx, recv, **rkw), 50, "frontier_row")}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
