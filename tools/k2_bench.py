#!/usr/bin/env python3
"""Time kernel K2 (the group wavefront, ``csrc/group_wavefront.cu``) on
seeded shapes of the port's main paths, on one CUDA card.

Run from the repository root:

    python3 tools/k2_bench.py                  # time, held to the plain version
    python3 tools/k2_bench.py --root DIR       # the port of another checkout
    python3 tools/k2_bench.py --ablate crg     # a step without its crg sums
    python3 tools/k2_bench.py --shapes dna6400,dna24k --variant cluster,wide \
        --ctas 4,6,7,8                         # cluster sizes against wide
    python3 tools/k2_bench.py --shapes dna6400,dna24k --profile

Shapes (random gapped, weighted protein groups and DNA pairs from a
fixed seed):

- ``bench``: 32 pairs of 8 x 384 members x columns, all members real;
- ``merge7``: one progressive merge as ``prrn`` pads it below 16
  sequences: 3 + 4 real members of ~520 columns, sides padded to 7;
- ``merge6x1``: ce13a17's last progressive merge: a profile of 6
  members against one sequence, ~520 columns, sides padded to 7;
- ``refine19``: one refinement candidate of a 19-member family: 9 + 10
  real members of 172 and 526 columns, sides padded to 19;
- ``dna6400``: a 5.3 kb DNA pair at the default window (6,400 slots), a
  chunk of 256 steps from the carry at step 5,001;
- ``dna24k``: the 20 kb DNA pair of ``chip_smoke.py``'s phase 12 (24,064
  slots), a chunk of 256 steps from the carry at step 20,480.

The first four run whole from the DP corner.  ``--variant`` times each
variant named (default: the plan's), and ``--ctas`` the cluster variant
at each size named (default: the plan's).  ``--root`` imports
``prrn_aln_tpu_torch`` from another checkout (an unpacked parent
commit), so two kernels are compared in one run on one card.
``--ablate`` cuts a loop of the kernel to no iterations in a copy of the
sources under ``build/`` (``crg``: the member-pair sums; ``chan``: the
channel sums of the profile scores; ``runs``: the gap-run updates;
``all``: the three): the output is then wrong and is not checked; the
time says what the part costs a step.  ``--no-check`` skips the plain
version.  ``--profile`` builds the sources with ``-DK2_PROFILE``: each
thread of the cluster variant sums clock64() cycles by section of a step
(the profile scores, the edge slot and its push, the interior, the CTA
barrier, the cluster barrier's wait), printed as cycles a thread-step
and shares; and times the barrier chain (``k2_barrier_chain``: one
store into the next CTA's shared memory and the split cluster barrier a
step, nothing else) at each cluster size, the floor of a step.

Each checked kernel call is held to the plain version once, bit for bit
(score, planes and, for a chunk, the output carry); then prints one JSON
line a shape and plan: the median of warm calls (CUDA events), the
kernel's own device time (``torch.profiler``), microseconds a step,
real and padded member pairs, the variant, its CTAs, where its runs
live, and its registers.
"""

from __future__ import annotations

import argparse
import ctypes
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
    "runs": ["for (int i = 0; i < p.an_b; ++i) {",
             "for (int j = 0; j < p.bn_b; ++j) {"],
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


# the DNA shapes: nt of the pair, the start step of the timed chunk
DNA_SHAPES = {"dna6400": (5300, 5001), "dna24k": (20000, 20480)}
CHUNK = 256
# sections of a step of the cluster variant (kSecSpan .. kSecWait)
PROFILE_SECTIONS = ("span", "edge", "interior", "cta_barrier",
                    "cluster_wait")


def dna_mutant(rng, base, sub=0.03, indels=2):
    """chip_smoke.py's mutant: substitutions and short indels."""
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
    return mut


def dna_inputs(name: str, dev, G, ab, Msa, stripe):
    """Packed K2 inputs of a DNA pair (phase 12's generator) and its
    chunk's launch sizes."""
    from prrn_aln_tpu_torch import scoring
    from prrn_aln_tpu_torch.config import default_params
    dna, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
    nt, d0 = DNA_SHAPES[name]

    def msa(arr):
        m = Msa(codes=ab.encode("".join("ACGT"[c] for c in arr),
                                ab.DNA)[None, :], molc=ab.DNA, names=["g"])
        m.prepare(dna.shape[0])
        return m

    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, nt)
    A, B = msa(base), msa(dna_mutant(rng, base))
    w = stripe(A.length, B.length, -60)
    nslot = G._bucket(w.up - w.lw + 3, 128)
    ins = G.stack_inputs([G._pack_inputs(
        A, B, dna, 2.0, 9.0, w, 1, 1, G._bucket(A.length),
        G._bucket(B.length), uniform=False)], dev)
    return ins, dict(nslot=nslot, nsteps=CHUNK, d0=d0)


def shape_inputs(name: str, dev, G, ab, Msa, mtx, stripe):
    """Packed K2 inputs and launch sizes of a shape."""
    if name in DNA_SHAPES:
        return dna_inputs(name, dev, G, ab, Msa, stripe)
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


def device_ms(fn, reps: int):
    """The kernel's own time a call on the card (``torch.profiler``
    device time of the kernels named group_wavefront), without the
    wrapper's host work; None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if "group_wavefront" in ev.key)
    return total / reps / 1e3 if total else None


def profile_read(_build, clear: bool) -> dict:
    """Cycles a thread-step by section, summed since the last clear."""
    fn = _build.load().k2_profile_read
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = (ctypes.c_ulonglong * (len(PROFILE_SECTIONS) + 1))()
    _build.check(fn(ctypes.addressof(out), int(clear)), "k2_profile_read")
    steps = max(out[len(PROFILE_SECTIONS)], 1)
    return {name: out[k] / steps for k, name in enumerate(PROFILE_SECTIONS)}


def barrier_chain_us(_build, ctas: int, threads: int, steps: int = 20000):
    """Microseconds a step of the barrier chain on a cluster of ``ctas``
    CTAs of ``threads`` threads (CUDA events around one launch, after a
    warm one)."""
    fn = _build.load().k2_barrier_chain_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    out = torch.zeros(ctas, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check(fn(ctas, threads, steps, out.data_ptr(), stream),
                     "k2_barrier_chain_launch")
    ms = time_ms(run, 3)
    torch.cuda.synchronize()
    if int(out[0]) != steps:    # the chain's count came round in order
        raise AssertionError(f"barrier chain: {out.tolist()} != {steps}")
    return ms * 1e3 / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--ablate", choices=sorted(ABLATIONS))
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--shapes", default="bench,merge7,merge6x1,refine19")
    ap.add_argument("--variant", default="",
                    help="variants to time, comma-separated (default: "
                    "the plan's)")
    ap.add_argument("--ctas", default="",
                    help="cluster sizes to time, comma-separated")
    ap.add_argument("--profile", action="store_true",
                    help="clock cycles a step of the cluster variant by "
                    "section, and the barrier chain")
    ap.add_argument("--reps", type=int, default=7)
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
    if args.profile:
        _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DK2_PROFILE"]
        _build._BUILD = REPO / "build" / "k2_profile_lib"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cluster = hasattr(G, "cluster_shape")
    variants = [v for v in args.variant.split(",") if v] or [None]
    sizes = [int(x) for x in args.ctas.split(",") if x] or [None]
    for name in args.shapes.split(","):
        ins, kw = shape_inputs(name, dev, G, ab, Msa, mtx, stripe)
        carry = None
        if kw.get("d0"):
            carry = G.group_wavefront(ins, nslot=kw["nslot"],
                                      nsteps=kw["d0"])[3]
            kw["carry"] = carry
        ref = None
        if check:
            ref = G.group_wavefront_ref(ins, **kw)
        plans = [(v, c) for v in variants
                 for c in (sizes if v == "cluster" else [None])]
        for variant, ctas in plans:
            opt = {}
            if variant:
                opt["variant"] = variant
            if ctas:
                opt["ctas"] = ctas
            plan = (G.wavefront_plan(ins, nslot=kw["nslot"], **opt)
                    if hasattr(G, "wavefront_plan") else {"variant": "one"})
            if check:
                got = G.group_wavefront(ins, **kw, **opt)
                torch.cuda.synchronize()
                same = (torch.equal(got[0].view(torch.int32),
                                    ref[0].view(torch.int32))
                        and torch.equal(got[1], ref[1])
                        and torch.equal(got[2], ref[2])
                        and (carry is None or G.carry_equal(got[3], ref[3])))
                if not same:
                    raise AssertionError(f"K2 != plain on {name} {opt}")
                del got
            if args.profile and plan["variant"] == "cluster":
                profile_read(_build, clear=True)
            ms = time_ms(lambda: G.group_wavefront(ins, **kw, **opt),
                         args.reps)
            dms = device_ms(lambda: G.group_wavefront(ins, **kw, **opt),
                            args.reps)
            real = ((ins["wa"] != 0).sum(1) * (ins["wb"] != 0).sum(1)).max()
            rec = {"shape": name, "root": str(root), "ms": ms,
                   "us_per_step": ms * 1e3 / kw["nsteps"],
                   "device_ms": dms,
                   "device_us_per_step": dms and dms * 1e3 / kw["nsteps"],
                   "nslot": kw["nslot"], "nsteps": kw["nsteps"],
                   "d0": kw.get("d0", 0),
                   "real_member_pairs": int(real),
                   "padded_member_pairs": ins["wa"].shape[1]
                   * ins["wb"].shape[1],
                   "variant": plan["variant"], "asked": opt,
                   "ablate": args.ablate, "checked": check}
            if cluster:
                rec.update(ctas=plan["ctas"], runs=plan["runs"],
                           slots_per_cta=plan["slots_per_cta"],
                           smem_bytes=plan["smem_bytes"],
                           **G.group_wavefront_attrs(False, plan["variant"],
                                                     plan["runs"]))
            if args.profile and plan["variant"] == "cluster":
                cyc = profile_read(_build, clear=True)
                total = sum(cyc.values())
                rec.update(profile_cycles_a_step=cyc,
                           profile_shares={k: v / total
                                           for k, v in cyc.items()},
                           barrier_chain_us_per_step=barrier_chain_us(
                               _build, plan["ctas"],
                               G.cluster_shape(1, 1, kw["nslot"], 1, 1, False,
                                               plan["ctas"])["threads"]))
            print(json.dumps(rec), flush=True)
        del ins, ref, carry, kw
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
