#!/usr/bin/env python3
"""Time kernels K1 (the banded pairwise scorer, ``csrc/pairwise.cu``), K3
(the group traceback walk, ``csrc/traceback.cu``), K1f (the row-sweep
pairwise scorer, ``csrc/pairwise_rows.cu``) and K4w (the fwd2h traceback
walk, ``csrc/spliced_h_walk.cu``) on the port's own shapes, on one CUDA
card.

Run from the repository root:

    python3 tools/k1k3_bench.py --inputs build/k1k3.pt
    python3 tools/k1k3_bench.py --inputs build/k1k3.pt --root DIR
    python3 tools/k1k3_bench.py --inputs build/k1k3.pt \\
        --k3-plans staged:16,global --k1-plans warp:10,warps:2x5,block
    python3 tools/k1k3_bench.py --inputs build/k1k3.pt --ablate nobar
    python3 tools/k1k3_bench.py --inputs build/k1k3.pt --kernels k1f,k4w \\
        --k1f-plans warp:32,warps:8,block --k4w-depths 64,256

Shapes:

- ``ce13a17``: every K1 and K3 call of ``prrn -R 0`` on
  ``tests/fixtures/ce13a17_clean.fa`` (one K1 call of 21 pairs; 28 K3
  calls of one pair: 6 merges at nslot 640 and 22 refinement candidates
  at nslot 128); K3 is timed at its longest walk (``widest``), at the
  longest refinement walk and summed over the 28 calls;
- ``fam19``: ``prrn -R 0`` on ``tests/fixtures/fam19.fa``: K1 on the
  forest's edge batch (101 pairs of 145-520 residues) and K3 summed over
  its 231 calls (the run takes about a minute on the card);
- ``bench32``: K3 on 32 pairs of 8 x 384 seeded random groups (the
  planes K2 makes of them);
- ``bench512``: K1 on 512 seeded random pairs of 512 x 512 at sh=-60
  (a band of 617 slots), and ``bench150`` on 512 pairs of 150 x 150 (183
  slots: the band one warp a pair takes);
- K1f (``--kernels k1f``) on fam19's recorded edge call and on
  ``bench512``, each with the packing ``pairwise_scores`` gives it (lw0
  the batch's smallest lw);
- ``longdna`` (``--shapes longdna``, not recorded: made anew in each
  run, by whichever package runs): K1 on the distance pass of seeded DNA
  families of five at 9, 16 and 20 kb a side (a sequence and mutants at
  3, 5, 8 and 10 % substitutions with three short indels each, 10 pairs
  at ~10,800, ~19,200 and ~24,000 slots) and on their first pair alone,
  in each plan of ``--long-k1-plans`` (``block``: the band in shared
  memory where it fits; ``device``: in device memory; ``cluster:P``,
  ``cluster:PxE`` or ``cluster:PxExG``: P CTAs, an exchange every E
  steps, G ghost lanes a side); K1f on the same
  batches in its default plan (the cluster variant) and each plan of
  ``--k1f-plans`` (``block``: the row in shared or device memory;
  ``cluster:P`` or ``cluster:PxL``: P CTAs of L lanes a thread); K3
  on the walks of ``prrn -R 0`` on ``chip_smoke.DNA_FAMILY`` (6 kb, its
  merges at 7,296 slots) and on the 20 kb pair's planes (24,064 slots,
  K2 on the card): the walk from the end and a range walk over a chunk
  of 2,048 rows, in each plan of ``--long-k3-plans`` (``window``,
  ``window:T:W:S``, ``global``);
- K4w (``--kernels k4w``) on the walks ``aln -yl2`` records on the card
  for (a) mini_gen x mini_pro, (c) the CET10B9 window x ce13a.msa and
  the flagship's shape (the window at 31,400 in seeded random flanks of
  34.9 kb, x ce13a.msa); recorded anew in each run (the planes take
  40 MB at (c) and 390 MB at the flagship shape), by whichever package
  runs.

The recorded inputs are written to ``--inputs`` by the first run and read
back by later ones, so another checkout's kernels (``--root``: an
unpacked parent commit, whose ``prrn_aln_tpu_torch`` is imported in its
place) are timed on the same inputs in the same call.  Every timed
kernel call is held to its plain version bit for bit, or the script
raises.  In this checkout, ``--k3-plans`` times K3 in other plans
(``staged:T`` for T rows a tile, ``global``),
``--k1-plans`` K1 in other plans (``warp:L``, ``warps:LxW``
for L slot pairs a lane and W warps a pair, ``block``).  ``--ablate``
builds a copy of the sources under ``build/`` with a part of K1's step,
or of K1f's cluster row (``k1f_*``), taken out (ABLATIONS: its scores
are wrong and not checked; the time says what the part costs).  ``--shapes`` leaves out the ``fam19`` run,
``--kernels`` one of the two kernels.

Prints the card and its power limit, then one JSON line a timed call:
the median of warm calls through the wrapper (CUDA events, host work of
the wrapper included, as the main path sees it), the kernel's own time
on the card (``device_ms``, from ``torch.profiler``; null where it shows
none; for K1f and K4w also ``queued_ms``, CUDA events around launches
enqueued back to back), the plan, microseconds a walk move (K3, of the longest walk) or a
step (K1), a row (K1f) or a walk step (K4w), K4w's reads of ev from its
ring and from device memory, and the plan's registers and spilled bytes.
``--root`` runs another checkout's K1f and K4w on the same inputs too
(its wrappers may take fewer arguments: the older K1f takes no
``nlane``, the older K4w no plan).
"""

from __future__ import annotations

import argparse
import inspect
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
# parts of K1's step an ablation takes out in a copy of the sources
ABLATIONS = {
    # K1f's cluster variant (csrc/pairwise_rows.cu): the row's cluster
    # barrier, the pushes into the other CTAs, the CTA's named barrier
    "k1f_nocluster": [("        cluster_arrive();\n        cluster_wait();\n"
                       "        const float t2", "        const float t2")],
    "k1f_nopush": [("            cluster.map_shared_rank(xb, lane)[rank] = "
                    "c_next;", "            (void)0;"),
                   ("            nx[18] = H[L - 1];\n"
                    "            nx[19] = carry;\n", ""),
                   ("          pv[16] = H[0];\n"
                    "          pv[17] = G[0];\n", "")],
    "k1f_nonamed": [("        eb[4 * nwarps + warp] = carry;\n      }\n"
                     "      named_sync(blockDim.x);",
                     "        eb[4 * nwarps + warp] = carry;\n      }")],
    # the named barrier of a step (the warps variant)
    "nobar": [("        wb[4 * warp + 3] = st.Fo[L - 1];\n      }\n"
               "      named_sync(blockDim.x);",
               "        wb[4 * warp + 3] = st.Fo[L - 1];\n      }")],
    # the substitution scores' loads (a constant score)
    "noscore": [("s[i] = smtx[sa[mc] * dim + sb[nc]];", "s[i] = 1.0f;")],
    # the shuffles between lanes (each lane its own neighbour)
    "noshfl": [("__shfl_up_sync(kFull, st.Ho[L - 1], 1)", "st.Ho[L - 1]"),
               ("__shfl_up_sync(kFull, st.Fo[L - 1], 1)", "st.Fo[L - 1]"),
               ("__shfl_down_sync(kFull, st.He[0], 1)", "st.He[0]"),
               ("__shfl_down_sync(kFull, st.Ge[0], 1)", "st.Ge[0]")],
}


def device_ms(fn, reps: int, word: str):
    """The kernel's own time a call on the card: the device time of the
    kernels whose names hold ``word``, from ``torch.profiler``, over
    ``reps`` calls; None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if word in ev.key:
            total += (getattr(ev, "device_time_total", 0)
                      or getattr(ev, "cuda_time_total", 0))
    return total / reps / 1e3 if total else None


def ablated_sources(part: str) -> Path:
    """A copy of the kernel sources with the part ``part`` taken out."""
    out = REPO / "build" / f"k1_ablate_{part}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(REPO / "prrn_aln_tpu_torch" / "csrc", out)
    src = out / ("pairwise_rows.cu" if part.startswith("k1f_")
                 else "pairwise.cu")
    text = src.read_text()
    for old, new in ABLATIONS[part]:
        if old not in text:
            raise ValueError(f"no {old!r} in {src}")
        text = text.replace(old, new)
    src.write_text(text)
    return out


def queued_ms(launch, reps: int) -> float:
    """A kernel's time a launch with launches enqueued back to back (CUDA
    events, no synchronisation between them): ``launch`` enqueues the
    kernel alone, so the card and not the host sets the pace."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def to(obj, dev):
    """Tensors of nested tuples and dicts moved to ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to(x, dev) for x in obj)
    if isinstance(obj, dict):
        return {k: to(x, dev) for k, x in obj.items()}
    return obj


def record_prrn(pkg, fasta: Path) -> dict:
    """Run ``prrn -R 0`` on the card with recorders at K1's and K3's
    launch points; returns their calls' arguments on the host."""
    from importlib import import_module
    pw = import_module(f"{pkg}.ops.pairwise")
    G = import_module(f"{pkg}.ops.group")
    cli = import_module(f"{pkg}.cli")
    calls = {"k1": [], "k3": []}
    real_k1, real_k3 = pw._launch_pairwise, G.traceback

    def k1(*args):
        calls["k1"].append(to(args, "cpu"))
        return real_k1(*args)

    def k3(*args, **kw):
        calls["k3"].append((to(args, "cpu"), kw["max_iters"]))
        return real_k3(*args, **kw)

    pw._launch_pairwise, G.traceback = k1, k3
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rc = cli.prrn_main(["-R", "0", str(fasta), "-o",
                                str(Path(tmp) / "out.txt"), "--device",
                                "cuda"])
    finally:
        pw._launch_pairwise, G.traceback = real_k1, real_k3
    if rc != 0:
        raise AssertionError(f"prrn_main returned {rc} on {fasta.name}")
    return calls


def bench32_k3(dev) -> list:
    """K3's arguments on K2's planes of 32 pairs of 8 x 384 groups."""
    from prrn_aln_tpu_torch import alphabet as ab, scoring
    from prrn_aln_tpu_torch.config import AlnParams
    from prrn_aln_tpu_torch.msa.msa import Msa
    from prrn_aln_tpu_torch.ops import group as G
    from prrn_aln_tpu_torch.ops.window import stripe
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    rng = np.random.default_rng(0)

    def new(many, L):
        codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
        codes[rng.random((many, L)) < 0.08] = ab.GAP
        codes[:, 0] = ab.ALA + rng.integers(0, 20)
        m = Msa(codes=codes, molc=ab.PROTEIN,
                names=[f"s{i}" for i in range(many)],
                weight=rng.random(many) + 0.5)
        m.prepare(mtx.shape[0])
        return m

    pairs = [(new(8, 384), new(8, 384)) for _ in range(32)]
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    nslot = G._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    nsteps = G._bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    items = [G._pack_inputs(A, B, mtx, 2.0, 9.0, w, 8, 8, 384, 384,
                            spb=20.0) for (A, B), w in zip(pairs, wd)]
    ins = G.stack_inputs(items, dev)
    dirs, opens = G.group_wavefront(ins, nslot=nslot, nsteps=nsteps)[1:3]
    args = (dirs, opens, ins["la"], ins["lb"], ins["lw"])
    return [(to(args, "cpu"), 2 * (384 + 384) + 4)]


def bench512_k1(L: int = 512) -> tuple:
    """K1's arguments on 512 random pairs of L x L at sh=-60."""
    from prrn_aln_tpu_torch import scoring
    from prrn_aln_tpu_torch.config import AlnParams
    from prrn_aln_tpu_torch.ops.window import stripe
    rng = np.random.default_rng(0)
    B = 512
    A = torch.as_tensor(rng.integers(3, 23, size=(B, L)).astype(np.int32))
    Bm = torch.as_tensor(rng.integers(3, 23, size=(B, L)).astype(np.int32))
    w = stripe(L, L, -60)
    full = lambda x, dt: torch.full((B,), x, dtype=dt)  # noqa: E731
    prot, _ = scoring.protein_matrix(AlnParams(pam=150))
    return (A, Bm, full(L, torch.int32), full(L, torch.int32),
            full(w.lw, torch.int32), full(w.up, torch.int32),
            torch.as_tensor(prot), *(full(x, torch.float32)
                                     for x in (2.0, 9.0, 1.0)),
            torch.zeros((B, 4), dtype=torch.bool), False)


def record_inputs(path: Path, dev, fam19: bool) -> dict:
    ce = record_prrn("prrn_aln_tpu_torch", FIX / "ce13a17_clean.fa")
    data = {"ce13a17": ce, "bench32": bench32_k3(dev),
            "bench512": bench512_k1(), "bench150": bench512_k1(150)}
    if fam19:
        data["fam19"] = record_prrn("prrn_aln_tpu_torch", FIX / "fam19.fa")
    torch.save(data, path)
    return data


def parse_k3_plan(text: str) -> dict:
    variant, _, rows = text.partition(":")
    if variant == "global":
        return {"variant": "global"}
    return {"variant": "staged", "tile_rows": int(rows)}


def parse_k1_plan(text: str) -> dict:
    if text == "block":
        return {"variant": "block"}
    variant, _, size = text.partition(":")
    if variant == "warp":
        return {"variant": "warp", "lanes": int(size)}
    lanes, _, warps = size.partition("x")
    return {"variant": "warps", "lanes": int(lanes), "warps": int(warps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", type=Path, required=True)
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--k3-plans", default="")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--shapes", default="ce13a17,fam19,bench")
    ap.add_argument("--kernels", default="k1,k3")
    ap.add_argument("--k1-plans", default="")
    ap.add_argument("--k1f-plans", default="")
    ap.add_argument("--k4w-depths", default="")
    ap.add_argument("--long-k1-plans", default="")
    ap.add_argument("--long-k3-plans", default="")
    ap.add_argument("--long-nt", default="9000,16000,20000")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1k3_bench: CUDA is not available", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from prrn_aln_tpu_torch.ops import _build, group as G, pairwise as pw
    if args.ablate:
        _build._CSRC = ablated_sources(args.ablate)
        _build._BUILD = REPO / "build" / f"k1_ablate_{args.ablate}_lib"
    check = not args.ablate
    shapes = args.shapes.split(",")
    kernels = args.kernels.split(",")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if shapes == ["longdna"]:
        return long_dna(args, root == REPO, dev)
    if args.inputs.exists():
        data = torch.load(args.inputs)
    else:
        if root != REPO:
            raise SystemExit("record the inputs with this checkout first")
        args.inputs.parent.mkdir(parents=True, exist_ok=True)
        data = record_inputs(args.inputs, dev, "fam19" in shapes)
    here = root == REPO

    def emit(obj):
        obj = {"root": str(root), "ablate": args.ablate, **obj}
        print(json.dumps(obj), flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(obj) + "\n")

    # K3: the plans to time, each held to the plain walk
    k3_plans = [None]
    if here and args.k3_plans:
        k3_plans += [parse_k3_plan(t) for t in args.k3_plans.split(",")]

    def k3_run(call, ask):
        (dirs, opens, La, Lb, lw), mi = to(call, dev)
        kw = {"max_iters": mi}
        plan = None
        if ask is not None:
            plan = G.traceback_plan(dirs.shape[1], dirs.shape[2], mi, **ask)
            kw["plan"] = plan
        elif hasattr(G, "traceback_plan"):
            plan = G.traceback_plan(dirs.shape[1], dirs.shape[2], mi)
        fn = lambda: G.traceback(dirs, opens, La, Lb, lw, **kw)  # noqa
        mk, ck = fn()
        mr, cr = G.traceback_ref(dirs, opens, La, Lb, lw, max_iters=mi)
        torch.cuda.synchronize()
        if not (torch.equal(mk, mr) and torch.equal(ck, cr)):
            raise AssertionError(f"K3 != plain ({plan})")
        return fn, plan, int(cr.max()), dirs.shape

    def k3_report(name, calls, ask, total=False):
        ms, dms, moves, plan, shape = [], [], 0, None, None
        for call in calls:
            try:
                fn, plan, walk, shape = k3_run(call, ask)
            except ValueError as err:     # a plan the kernel cannot take
                emit({"kernel": "K3", "shape": name, "ask": ask,
                      "refused": str(err)})
                return
            ms.append(time_ms(fn, args.reps if not total else 3))
            dms.append(device_ms(fn, args.reps if not total else 3,
                                 "traceback"))
            moves = max(moves, walk)
        dev_ms = None if None in dms else sum(dms)
        attrs = ({} if plan is None or not hasattr(G, "traceback_attrs")
                 else G.traceback_attrs(plan["variant"]))
        dims = ({} if total else
                {"pairs": shape[0], "nsteps": shape[1], "nslot": shape[2]})
        emit({"kernel": "K3", "shape": name, "calls": len(calls),
              "ms": sum(ms), "device_ms": dev_ms, "max_call_ms": max(ms),
              **dims,
              "longest_walk_moves": moves,
              "us_per_move": max(ms) * 1e3 / max(moves, 1),
              "plan": None if total else plan, **attrs, "checked": check})

    ce_k3 = data["ce13a17"]["k3"]
    walks = [int((c[0][2] + c[0][3]).max()) for c in ce_k3]
    widest = max(range(len(ce_k3)), key=lambda i: walks[i])
    refine = [i for i, c in enumerate(ce_k3) if c[0][0].shape[2] == 128]
    longest_refine = max(refine, key=lambda i: walks[i]) if refine else widest
    if "k3" not in kernels:
        k3_plans, check3 = [], False
    else:
        check3 = check
    for ask in k3_plans if check3 else ():
        k3_report("ce13a17_widest", [ce_k3[widest]], ask)
        k3_report("ce13a17_refine", [ce_k3[longest_refine]], ask)
        if "bench" in shapes:
            k3_report("bench32", data["bench32"], ask)
    if check3:
        k3_report("ce13a17_all", ce_k3, None, total=True)
    if check3 and "fam19" in shapes:
        k3_report("fam19_all", data["fam19"]["k3"], None, total=True)

    # K1: the default plan, and the plans asked for, each held to the plain
    # version
    k1_asks = [None]
    if here and args.k1_plans:
        k1_asks += [parse_k1_plan(t) for t in args.k1_plans.split(",")]
    k1_sets = [("ce13a17", data["ce13a17"]["k1"][0])] if "k1" in kernels else []
    if "fam19" in shapes and k1_sets:
        k1_sets.append(("fam19_edges", data["fam19"]["k1"][0]))
    if "bench" in shapes and k1_sets:
        k1_sets.append(("bench512", data["bench512"]))
        k1_sets.append(("bench150", data["bench150"]))
    for name, call in k1_sets:
        call = to(call, dev)
        ref = pw._plain_pairwise(*call)
        a_batch, b_batch, la, lb, lw, up = call[:6]
        cells = pw.band_cells(*(x.cpu().numpy() for x in (la, lb, lw, up)))
        maxw = int((up - lw).max()) + 3
        for ask in k1_asks:
            plan = None
            extra = ()
            if hasattr(pw, "pairwise_plan"):
                try:
                    plan = pw.pairwise_plan(
                        maxw, a_batch.shape[0], call[6].shape[0],
                        a_batch.shape[1], b_batch.shape[1], **(ask or {}))
                except ValueError as err:
                    emit({"kernel": "K1", "shape": name, "ask": ask,
                          "refused": str(err)})
                    continue
                extra = (plan,)
            fn = lambda: pw._launch_pairwise(*call, *extra)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            if check and not torch.equal(got.view(torch.int32),
                                         ref.view(torch.int32)):
                raise AssertionError(f"K1 != plain on {name} ({plan})")
            ms = time_ms(fn, args.reps)
            dev_ms = device_ms(fn, args.reps, "pairwise")
            steps = int((la + lb).max()) - 1
            attrs = ({} if plan is None or not hasattr(pw, "pairwise_attrs")
                     else pw.pairwise_attrs(plan, bool(call[11])))
            emit({"kernel": "K1", "shape": name, "ms": ms,
                  "device_ms": dev_ms,
                  "pairs": a_batch.shape[0], "maxw": maxw, "steps": steps,
                  "us_per_step": ms * 1e3 / steps, "band_cells": cells,
                  "gcups": cells / (ms * 1e6), "plan": plan, **attrs,
                  "checked": check})

    if "k1f" in kernels:
        k1f_sets = [("bench512", data["bench512"][:11])]
        if "fam19" in data:
            k1f_sets.insert(0, ("fam19_edges", data["fam19"]["k1"][0][:11]))
        asks = [None]
        if here and args.k1f_plans:
            asks += [parse_k1f_plan(t) for t in args.k1f_plans.split(",")]
        for name, call in k1f_sets:
            k1f_report(emit, pw, name, to(call, dev), asks, args.reps)
    if "k4w" in kernels:
        from importlib import import_module
        SH = import_module("prrn_aln_tpu_torch.ops.spliced_h")
        depths = [None]
        if here and args.k4w_depths:
            depths += [int(t) for t in args.k4w_depths.split(",")]
        for name, wargs in record_walks(SH).items():
            k4w_report(emit, SH, name, wargs, depths, args.reps)
    return 0


def parse_k1f_plan(text: str) -> dict:
    if text == "block":
        return {"variant": "block"}
    if text.startswith("cluster:"):
        # cluster:P or cluster:PxL: P CTAs (of L lanes a thread)
        ctas, _, lanes = text.partition(":")[2].partition("x")
        ask = {"variant": "cluster", "ctas": int(ctas)}
        if lanes:
            ask["lanes"] = int(lanes)
        return ask
    variant, _, size = text.partition(":")
    lanes, _, warps = size.partition("x")
    ask = {"variant": variant, "lanes": int(lanes)}
    if warps:
        ask["warps"] = int(warps)
    return ask


def k1f_report(emit, pw, name, call, asks, reps, queued=20,
               check=True) -> None:
    """K1f on one batch in each plan asked for, held to its plain
    version bit for bit unless ``check`` is off (``queued``: launches
    queued back to back for ``queued_ms``)."""
    a_batch, b_batch, la, lb, lw, up = call[:6]
    lw0 = int(lw.min())
    nlane = int(up.max()) - lw0 + 1
    ref = pw.row_scores_ref(*call, lw0=lw0, nlane=nlane, nrow=int(la.max()))
    cells = pw.band_cells(*(x.cpu().numpy() for x in (la, lb, lw, up)))
    new = "nlane" in inspect.signature(pw._launch_rows).parameters
    rows = int(la.max())
    for ask in asks:
        plan = None
        extra = (lw0,)
        if new:
            try:
                plan = pw.rows_plan(nlane, a_batch.shape[0],
                                    call[6].shape[0], a_batch.shape[1],
                                    b_batch.shape[1], **(ask or {}))
            except ValueError as err:
                emit({"kernel": "K1f", "shape": name, "ask": ask,
                      "refused": str(err)})
                continue
            extra = (lw0, nlane, plan)
        fn = lambda: pw._launch_rows(*call, *extra)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        if check and not torch.equal(got.view(torch.int32),
                                     ref.view(torch.int32)):
            raise AssertionError(f"K1f != plain on {name} ({plan})")
        ms = time_ms(fn, reps)
        dms = device_ms(fn, reps, "pairwise_rows")
        exg_u8 = call[10].to(torch.uint8)
        qms = queued_ms(lambda: pw._launch_rows(*call[:10], exg_u8, *extra),
                        queued)
        attrs = pw.rows_attrs(plan) if plan else {}
        emit({"kernel": "K1f", "shape": name, "ms": ms, "device_ms": dms,
              "queued_ms": qms,
              "pairs": a_batch.shape[0], "lanes": nlane, "rows": rows,
              "us_per_row": ms * 1e3 / rows,
              "device_us_per_row": None if dms is None else dms * 1e3 / rows,
              "band_cells": cells, "gcups": cells / (ms * 1e6),
              "plan": plan, **attrs, "checked": check})


def dna_family(nt: int, seed: int, subs=(0.03, 0.05, 0.08, 0.10),
               indels: int = 3) -> list:
    """A seeded random DNA sequence of ``nt`` and its mutants
    (``chip_smoke.mutate``'s: short indels, then substitutions)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, nt)
    out = [base]
    for sub in subs:
        mut = list(base)
        for _ in range(indels):
            p = int(rng.integers(200, len(mut) - 200))
            if rng.random() < 0.5:
                del mut[p:p + int(rng.integers(1, 4))]
            else:
                mut[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
        mut = np.array(mut)
        m = rng.random(len(mut)) < sub
        mut[m] = rng.integers(0, 4, int(m.sum()))
        out.append(mut)
    return out


def record_distance_call(seqs) -> tuple:
    """K1's arguments for the distance pass of ``seqs`` (DNA, prrn's
    defaults), as ``msa/distance.all_pairs_scores`` packs them."""
    from prrn_aln_tpu_torch import alphabet as ab, scoring
    from prrn_aln_tpu_torch.config import default_params
    from prrn_aln_tpu_torch.msa import distance
    from prrn_aln_tpu_torch.ops import pairwise as pw
    params = default_params(ab.DNA, "prrn")
    mtx, _ = scoring.build_matrix(ab.DNA, params)
    codes = [ab.encode("".join("ACGT"[c] for c in s), ab.DNA)
             for s in seqs]
    got = []
    real = pw._launch_pairwise

    def rec(*a):
        got.append(a)
        return torch.zeros(a[0].shape[0], device=a[0].device)

    pw._launch_pairwise = rec
    try:
        distance.all_pairs_scores(codes, mtx, params.u, params.v, params.sh,
                                  device="cuda")
    finally:
        pw._launch_pairwise = real
    return got[0]


def parse_long_k1(text: str) -> dict:
    if text == "block":
        return {"variant": "block", "state": "shared"}
    if text == "device":
        return {"variant": "block", "state": "device"}
    _, _, size = text.partition(":")
    ctas, every, ghost = (size.split("x") + [None, None])[:3]
    ask = {"variant": "cluster", "ctas": int(ctas)}
    if every:
        ask["every"] = int(every)
    if ghost:
        ask["ghost"] = int(ghost)
    return ask


def parse_long_k3(text: str) -> dict:
    if text == "global":
        return {"variant": "global"}
    parts = text.split(":")
    ask = {"variant": "window"}
    if len(parts) == 4:
        ask.update(tile_rows=int(parts[1]), width=int(parts[2]),
                   stages=int(parts[3]))
    return ask


def long_dna(args, here: bool, dev) -> int:
    """The ``longdna`` shapes (see the module's docstring)."""
    from prrn_aln_tpu_torch.ops import group as G, pairwise as pw
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    root = str(args.root.resolve())

    def emit(obj):
        obj = {"root": root, "card": card, "ablate": args.ablate, **obj}
        print(json.dumps(obj), flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(obj) + "\n")

    kernels = args.kernels.split(",")
    k1_asks = [None] + [parse_long_k1(t) for t in args.long_k1_plans.split(",")
                        if t]
    k1f_asks = [None] + [parse_k1f_plan(t) for t in args.k1f_plans.split(",")
                         if t]
    for nt in (int(x) for x in args.long_nt.split(",")):
        call = record_distance_call(dna_family(nt, nt))
        for batch in (10, 1):
            sub = tuple(x[:batch] if isinstance(x, torch.Tensor)
                        and x.dim() and x.shape[0] == 10 else x
                        for x in call)
            a_batch, b_batch, la, lb, lw, up = sub[:6]
            maxw = int((up - lw).max()) + 3
            steps = int((la + lb).max()) - 1
            cells = pw.band_cells(*(x.cpu().numpy()
                                    for x in (la, lb, lw, up)))
            name = f"dna{nt // 1000}k_b{batch}"
            ref = None
            if "k1" in kernels:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ref = pw._plain_pairwise(*sub)
                end.record()
                torch.cuda.synchronize()
                plain_ms = start.elapsed_time(end)
                for ask in k1_asks if here else [None, {"variant": "block"}]:
                    try:
                        plan = pw.pairwise_plan(maxw, batch, sub[6].shape[0],
                                                a_batch.shape[1],
                                                b_batch.shape[1],
                                                **(ask or {}))
                    except ValueError as err:
                        emit({"kernel": "K1", "shape": name, "ask": ask,
                              "refused": str(err)})
                        continue
                    fn = lambda: pw._launch_pairwise(*sub, plan)  # noqa
                    got = fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32)):
                        raise AssertionError(f"K1 != plain on {name} "
                                             f"({plan})")
                    ms = time_ms(fn, args.reps)
                    dms = device_ms(fn, args.reps, "pairwise")
                    # a band cell: 3 adds or subtractions and 6 maxima
                    nbytes = sum(x.numel() * x.element_size() for x in sub
                                 if isinstance(x, torch.Tensor)) + 4 * batch
                    emit({"kernel": "K1", "shape": name, "ask": ask,
                          "pairs": batch, "maxw": maxw, "steps": steps,
                          "ms": ms, "device_ms": dms,
                          "us_per_step": (dms or ms) * 1e3 / steps,
                          "plain_ms": plain_ms, "band_cells": cells,
                          "bound_ms": max(nbytes / 3.35e12,
                                          9 * cells / 67e12) * 1e3,
                          "plan": plan,
                          **(pw.pairwise_attrs(plan, False)
                             if hasattr(pw, "pairwise_attrs") else {}),
                          "checked": True})
            if "k1f" in kernels:
                k1f_report(emit, pw, name, sub[:11], k1f_asks if here
                           else [None], args.reps, queued=args.reps,
                           check=not args.ablate)
    if "k3" not in kernels:
        return 0
    k3_asks = [None] + [parse_long_k3(t) for t in args.long_k3_plans.split(",")
                        if t]
    if not here:
        k3_asks = [None]
    for name, calls in long_walks(G, dev).items():
        refs = [(G.traceback_range_ref if len(tb) == 7
                 else G.traceback_ref)(*tb, **kw) for tb, kw in calls]
        for ask in k3_asks:
            ms = dms = 0.0
            moves = 0
            plan = None
            for (tb, kw), ref in zip(calls, refs):
                dirs = tb[0]
                try:
                    plan = G.traceback_plan(dirs.shape[1], dirs.shape[2],
                                            kw["max_iters"], **(ask or {}))
                except ValueError as err:
                    emit({"kernel": "K3", "shape": name, "ask": ask,
                          "refused": str(err)})
                    break
                walk = G.traceback_range if len(tb) == 7 else G.traceback
                fn = lambda: walk(*tb, **kw, plan=plan)  # noqa: E731
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"K3 != plain on {name} ({plan})")
                ms += time_ms(fn, 3)
                dms += device_ms(fn, 3, "traceback") or float("nan")
                moves += int(ref[-1].sum())
            else:
                emit({"kernel": "K3", "shape": name, "ask": ask,
                      "calls": len(calls), "moves": moves, "ms": ms,
                      "device_ms": dms, "us_per_move": ms * 1e3 / moves,
                      "device_us_per_move": dms * 1e3 / moves,
                      "nsteps": calls[0][0][0].shape[1],
                      "nslot": calls[0][0][0].shape[2],
                      # a move reads a dirs and an opens byte, writes one
                      "bound_ms": 3 * moves / 3.35e12 * 1e3,
                      "plan": plan,
                      **(G.traceback_attrs(plan["variant"])
                         if hasattr(G, "traceback_attrs") else {}),
                      "checked": True})
    return 0


def long_walks(G, dev) -> dict:
    """K3's calls on long DNA: the walks of ``prrn -R 0`` on the 6 kb DNA
    family (recorded with their planes), the 20 kb pair's walk from the
    end and a range walk over the chunk of 2,048 rows at step 20,480 from
    its path."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as C
    from prrn_aln_tpu_torch import alphabet as ab, scoring
    from prrn_aln_tpu_torch.cli import prrn_main
    from prrn_aln_tpu_torch.config import default_params
    from prrn_aln_tpu_torch.ops.window import stripe
    out = {"dnafam6k": []}
    real = G.traceback

    def rec(*a, **kw):
        out["dnafam6k"].append((a, {"max_iters": kw["max_iters"]}))
        return real(*a, **kw)

    G.traceback = rec
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fa = Path(tmp) / "dnafam6k.fa"
            C.dna_family_fasta(fa)
            if prrn_main(["-R", "0", str(fa), "-o", str(Path(tmp) / "o"),
                          "--device", "cuda"]) != 0:
                raise AssertionError("prrn -R 0 failed on the DNA family")
    finally:
        G.traceback = real
    out["dnafam6k"] = [c for c in out["dnafam6k"] if c[0][0].shape[2] > 7000]
    dna, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, 20000)
    msas = []
    for arr in (base, C.mutate(rng, base)):
        m = C.Msa(codes=ab.encode("".join("ACGT"[c] for c in arr),
                                  ab.DNA)[None, :], molc=ab.DNA, names=["g"])
        m.prepare(dna.shape[0])
        msas.append(m)
    A, B = msas
    w = stripe(A.length, B.length, -60)
    nslot = G._bucket(w.up - w.lw + 3, 128)
    ins = G.stack_inputs([G._pack_inputs(
        A, B, dna, 2.0, 9.0, w, 1, 1, G._bucket(A.length),
        G._bucket(B.length), uniform=False)], dev)
    nsteps = G._bucket(A.length + B.length + 1, 64)
    _, dirs, opens, _ = G.group_wavefront(ins, nslot=nslot, nsteps=nsteps)
    mi = 2 * (A.length + B.length) + 4
    tb = (dirs, opens, ins["la"], ins["lb"], ins["lw"])
    out["dna20k"] = [(tb, {"max_iters": mi})]
    moves, cnts = G.traceback_ref(*tb, max_iters=mi)
    m, n = A.length, B.length
    d_lo, top = 20480, 20480 + 2047
    for mv in moves[0, :int(cnts[0])].tolist():
        if m + n <= top:
            break
        m -= mv in (0, 1)
        n -= mv in (0, 2)
    sub = tuple(x[:, d_lo:d_lo + 2048].contiguous() for x in (dirs, opens))
    starts = tuple(torch.tensor([v], dtype=torch.int32, device=dev)
                   for v in (m, n, 0, d_lo))
    out["dna20k_range"] = [((*sub, *starts, ins["lw"]),
                            {"max_iters": 2 * 2048 + 4})]
    return out


def flagship_genome() -> str:
    """The flagship's shape: the 2.3 kb CET10B9 window at 31,400 in
    seeded uniform random flanks to 34.9 kb (as chip_smoke.py builds
    it)."""
    from prrn_aln_tpu_torch import io as pio
    rng = np.random.default_rng(0)
    win = pio.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()

    def flank(k):
        return "".join(np.array(list("ACGT"))[rng.integers(0, 4, k)])

    return flank(31400) + win + flank(34900 - 31400 - len(win))


def record_walks(SH) -> dict:
    """K4w's arguments from ``aln -yl2`` runs on the card: (a), (c) and
    the flagship's shape."""
    from prrn_aln_tpu_torch.cli import aln_main
    walks = {}
    real = SH._launch_walk

    def rec(*a, **kw):
        walks[name] = a
        return real(*a, **kw)

    SH._launch_walk = rec
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fa = Path(tmp) / "flagship_shape.fa"
            g = flagship_genome()
            fa.write_text(">flagship_shape\n" + "\n".join(
                g[i:i + 60] for i in range(0, len(g), 60)) + "\n")
            for name, genome, query in (
                    ("mini", FIX / "mini_gen.fa", FIX / "mini_pro.fa"),
                    ("win_msa", FIX / "cet10b9_win31401.fa",
                     FIX / "ce13a.msa"),
                    ("flagship_shape", fa, FIX / "ce13a.msa")):
                rc = aln_main(["-yl2", str(genome), str(query), "-o",
                               str(Path(tmp) / "out.txt"), "--device",
                               "cuda"])
                if rc != 0:
                    raise AssertionError(f"aln_main returned {rc} on {name}")
    finally:
        SH._launch_walk = real
    return walks


def k4w_report(emit, SH, name, wargs, depths, reps) -> None:
    """K4w on one recorded walk at each ring depth asked for, held to the
    plain walk: the same knots, stop cell and steps."""
    ref = SH.walk_h_ref(*wargs)
    ev = wargs[0]
    for depth in depths:
        plan = None
        extra = ()
        if hasattr(SH, "walk_plan"):
            plan = SH.walk_plan(*ev.shape, depth=depth)
            extra = (plan,)
        elif depth is not None:
            continue
        fn = lambda: SH._launch_walk(*wargs, *extra)  # noqa: E731
        if fn() != ref:
            raise AssertionError(f"K4w != plain on {name} ({plan})")
        reads = dict(getattr(SH, "WALK_READS", {}))
        ms = time_ms(fn, reps)
        dms = device_ms(fn, reps, "walk")
        qms = (queued_ms(lambda: SH._enqueue_walk(*wargs, *extra), 20)
               if hasattr(SH, "_enqueue_walk") else None)
        steps = max(ref.steps, 1)
        attrs = (SH.spliced_h_walk_attrs()
                 if hasattr(SH, "spliced_h_walk_attrs") else {})
        emit({"kernel": "K4w", "shape": name, "ms": ms, "device_ms": dms,
              "queued_ms": qms,
              "waves": ev.shape[0], "rows": ev.shape[1],
              "walk_steps": ref.steps, "knots": len(ref.knots),
              "us_per_step": ms * 1e3 / steps,
              "device_us_per_step": None if dms is None else
              dms * 1e3 / steps, "reads": reads, "plan": plan, **attrs,
              "checked": True})


if __name__ == "__main__":
    sys.exit(main())
