#!/usr/bin/env python3
"""Smoke test of the PyTorch and CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

0. device: CUDA must be available; prints the card and its power limit;
1. build: compiles the eight CUDA kernel sources of
   ``prrn_aln_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. K1 (pairwise DP) against its plain PyTorch version on the card, on the
   pairwise fixtures and on 512 random pairs of 512 x 512 at sh=-60,
   with kernel and plain times, GCUPS and K1's launch plan (variant,
   slot pairs a lane, warps a pair, microseconds a step, registers and
   spilled bytes);
3. K2 (group wavefront) and K3 (traceback) against their plain versions
   on the card, bit for bit (K2's planes and scores), on the galign
   fixtures (ls=1 and ls=3), real member counts 1-7 padded to 7, a shape
   whose gap runs leave shared memory (K2's global variant) and a batch
   of 32 pairs of 8 members x 384 columns; each timed K2 call prints its
   real and padded member pairs, steps, microseconds a step, variant and
   registers, and the timed K3 call its plan (variant, tile rows,
   microseconds a move of the longest walk, registers);
4. the main path: ``prrn -R 0`` on ce13a17_clean.fa through the kernels,
   cold and warm, byte-identical to the JAX package's output fixture,
   every golden row exact, and every kernel launched;
5. every kernel call of a third ``prrn -R 0`` run, recorded with its
   inputs, against the plain version on the card, and each kernel's time
   at the main path's shapes (K2: the call with the most real member
   pairs), through its wrapper (CUDA events) and, for K1 and K3, the
   kernel's own (``torch.profiler``), with K1's and K3's plans;
6. the forest path (16 or more sequences): ``prrn -R 0`` on fam19.fa
   (19 proteins) through the kernels, byte-identical to the JAX
   package's output fixture, K1, K2 and K3 launched; then the same run
   once more under ``PRRN_PW_FUSED=1``: K1f launched and K1 not, the
   same edge list and forest, the same bytes; stage walls and summed
   kernel times of both runs (the second, warm run is the one under the
   switch), K3's time summed over the first run's launches; then K2's
   call of the first run with the most real member pairs (the last
   refinement's) against its plain version, and timed;
7. K1f (row-sweep pairwise DP) against its plain version on the card,
   bit for bit, on the global pairwise fixtures, on phase 2's 512 pairs
   and on the edge batch recorded in phase 6 (with the packing the edge
   pass launched); against K1 on the last two, at most 4 f32 ulp at the
   DP's scale; K1 and K1f times through the wrapper, K1f's on the device
   (launches queued back to back), and GCUPS, on the same inputs, with
   both plans (K1f: variant, lanes a
   thread, warps a pair, pairs a block, microseconds a row, registers
   and spilled bytes);
8. the forest path's shape, timing only: 64 seeded proteins of 150-250
   residues in 8 families through ``prrn -R 0 -I 0`` (no refinement,
   which at 64 members would outlast the script): the device k-mer pass,
   edges, tree sizes, jobs per batched launch, stage walls, kernel times;
9. K4 (spliced sweep) and K4w (its walk) against their plain versions on
   the card, on the inputs ``aln -yl2`` gives them for (a) mini_gen x
   mini_pro and (c) the 2.3 kb CET10B9 window x the ce13a.msa profile:
   planes, final band and knots equal; times, with K4's launch plan
   (variant, CTAs, rows a CTA), microseconds a wave, registers and
   spilled bytes, and K4w's time on the device (launches queued back
   to back) beside the wrapper's,
   its plan (ring waves, rows a slot, staging warps), walk steps,
   microseconds a step, reads of ev from the ring and from device
   memory, registers and spilled bytes.  On (b), the window x
   ce13a1, the kernels are timed and not held to the plain sweep (it
   takes over a minute there; the output of (b) is still held to its
   fixture in phase 10).  Then the long-intron gene (``long_intron_gene``:
   introns of 879 and 1,187 nt, where the intron penalty comes from its
   log tail): K4's three variants against the plain version, bit for
   bit (the chained one forced onto 2 clusters of 3 CTAs);
10. the gene-prediction path: ``aln -yl2`` on (a), (b) and (c) through
   the kernels, cold and warm, byte-identical to the JAX package's
   output fixtures (and mini's ``-O 5``/``-O 1`` to the reference's),
   both kernels launched;
11. the flagship's shape, timing only: a 34.9 kb genome (the window at
   31,400 in seeded random flanks) x ce13a.msa, with K4's and K4w's
   plans as in 9; then ``aln -yl2`` with proteins past what one cluster
   of K4 holds (``aln_yl2_long_protein``: ``LONG_PROTEINS`` lp2100,
   2,101 rows x 8.5 kb, and lp3500, 3,501 rows x 36 kb) cold and warm on
   K4's default plan, chained clusters: lp2100's output byte-identical to
   ``jax_aln_yl2_long_protein.txt``, K4's planes and band bit-equal to the
   global variant's and K4w's knots to the plain walk's on both, lp3500's
   output the same bytes under the global plan; K4's time, µs a wave,
   plan, registers and bound beside the global variant's, then the card
   line;
12. long pairs (``long_pair``): a 20 kb random DNA sequence and a mutant
   (3 % substitutions, two short indels) at the default window, 24,064
   slots (K2's wide variant).  (a) K2 resumed from carries against its
   plain version, bit for bit (planes, score, output carry), on the
   chunk at step 0 and two later chunks of 256 steps (one at an odd
   step), each from the kernel's own carry; the same on a 1,000 x 1,040
   protein pair of 3 members a side, ls=1 and ls=3, in the shared and
   the global variants; K3's range walk in both variants against its
   plain version on every one of those chunks.  (b) ``group_align`` and
   ``group_align_linear`` (chunks of 2,048 steps) on the pair: equal
   score bits and SKL, each one's wall, K2's variant, microseconds a
   step and registers, and peak device memory (the linear aligner's
   under a fifth of the standard's).  (c) ``seeded_align`` on the pair
   against (b)'s standard result (score within rel 1e-5 / abs 1e-2,
   the same SKL), its anchors, sub-DP batch and wall.
13. the ``prrn`` and ``aln`` modes (``cli_modes``), each run once with
   the launch counts set to 0 just before it, byte-identical to the JAX
   package's output fixture (``tools/write_jax_fixtures.py``): ``prrn -U
   -R 0`` on Multi_A/B and ``prrn -b guide5.nwk -R 0`` (every row of the
   reference's golden too), ``prrn -G`` on ce13a17 aligned, ``prrn
   --resume`` of the JAX package's checkpoint, ``prrn -e`` on fam19
   ``-I 0`` (all 7 sub-MSA files; K1, then K1f under ``PRRN_PW_FUSED=1``),
   ``aln`` on Multi_A x Multi_B (``golden_aln_multiAB.txt``; host
   aligner, no kernel), ``align_pair(ls=3)`` on the same pair (K2's
   long-gap lanes, against the JAX accelerator branch's output) and
   ``aln -R 10`` (11 scores in one K1 launch); each mode's wall and
   launches, then the card line;
14. spliced alignment of a cDNA against genomic DNA (``aln_G``, kernel
   K5): (a) ``aln -G`` on gen1 x cdna1 and gen2 x cdna2 in every mode
   (``-O 0, 2, 3, 4, 5`` and the default), each run with the launch
   counts set to 0 just before it, byte-identical to the JAX f32
   engine's fixtures ``jax_aln_G_gen{1,2}_*.txt``, one K5 launch each;
   each with the plan K5's wrapper picks;
   (b) K5 against its plain version, bit for bit (planes, final H band,
   and the score and knots lastS and the traceback make of them), the
   plan the wrapper picks (the cluster variant) and the global variant,
   on the inputs gen1, gen2 and a medium gene (~600 nt x 3.3 kb, two
   introns past 825 nt) give it, and on the medium gene the chained
   variant forced onto 5 clusters of 2 CTAs of 64 rows, in one launch
   and in passes of 2 clusters (the plain sweep on the card for gen2,
   timed, on a CPU copy of the inputs for the others); each variant's
   time, launch plan (variant, clusters, CTAs a cluster, rows a CTA,
   threads, rows a thread, clusters a launch, launches, what sits in
   shared memory), microseconds a wave, registers and spilled bytes;
   (c) the realistic gene (``GENES``: 8 exons, 7 introns of 300-4,000
   nt, ~2.2 kb against ~18 kb): the ``aln -G`` wall cold and warm, the
   host traceback's seconds, peak device memory, the cluster variant's
   planes and final band against the global variant's on the card, bit
   for bit, and both variants' times, plans and microseconds a wave;
   (d) the long gene (``GENES``: 12 exons, introns of 300-3,000 nt, a
   ~6.2 kb cDNA against ~27 kb, past what one cluster holds): ``aln -G
   -O 4`` cold and warm on the chained variant the wrapper picks (two or
   more clusters, asserted), peak device memory, its planes, final band,
   score and knots bit-equal to the global variant's and its output
   equal to the run under the global plan, both variants' times, plans
   and microseconds a wave, and the bound;
   (e) ``refgs`` on the in-repo family (as annotated, and with ce13a1's
   second exon perturbed and the MSA rebuilt) and ``refgs_main``,
   against the fixtures ``jax_refgs_*.txt``, with the launches of K4,
   K4w, K1, K2 and K3; then the card line;
15. the utility programs (``utils_cli``): every run of ``utils_cases``
   (``phyln`` UPGMA and NJ on dnafam, ce13a17 and fam19 at full width and
   ``-k`` on ce13a17 aligned; ``iden``, ``decomp``, ``makmdm``,
   ``makdbs``, ``rdn`` with each flag and writer, ``utn``, ``utp``), each
   with the launch counts set to 0 just before it, against the JAX
   package's standard output, error and files
   (``tests/fixtures/jax_utils_cli.json``); ``phyln`` without ``-k``
   launches K1 once, the others nothing; then the card line;
16. the multi-device paths on ``torch.distributed`` (``multi_device``):
   after the kernels are built, world 1 (a gloo group in this process)
   and world 2 (two spawned ranks), every rank on ``cuda:0``: the
   distance pass (K1, and K1f under ``PRRN_PW_FUSED=1``) and
   ``group_align_batch`` (K2, K3) bit-equal to the run with no group,
   each rank's block of the batch; ``build_msa`` on ce13a17 with ``-R
   0``'s settings byte-identical to ``jax_prrn_ce13a17_clean_R0.txt``;
   ``frontier_pairwise_score`` on tests/test_frontier.py's 96 x 96 pair
   and on a seeded 4 kb DNA pair at band +-256, equal to the run with no
   group and within 1e-3 relative of K1's score: at world 1 one K6s
   launch a score, its last H and G bit-equal to the plain sweep on the
   card; at world 2 one K6r launch and one read a row a rank on the
   skewed ring, one message each way a row toward a neighbour, K6r
   bit-equal to its plain version on each rank's recorded middle row;
   each run's ms a row and the share of it spent in the ring's messages;
   K6s's time on the 4 kb pair and K6r's a row; then the card line.

Prints one JSON line per phase, then the card line, the kernels line
(launches from the cold runs of phases 4 and 10, for K1f from the run
under the switch in phase 6, for K3's range walk from the linear
aligner's run in phase 12, each phase 13 mode's under ``cli_modes``,
K5's from ``aln -G`` on gen2 in phase 14, K6s's from phase 16's run
with no group and K6r's from rank 0 of its world-2 run, both on the 4 kb
pair; times at the main paths'
shapes, bounds from the same inputs) and, last, ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from prrn_aln_tpu_torch import alphabet as ab, io as pio, pipeline, scoring
from prrn_aln_tpu_torch.cli import aln_main, prrn_main
from prrn_aln_tpu_torch.config import AlnParams, default_params
from prrn_aln_tpu_torch.msa import distance, kmer, progressive, slforest, tree
from prrn_aln_tpu_torch.msa.merge import merge_msas
from prrn_aln_tpu_torch.msa.msa import Msa, msa_from_strings
from prrn_aln_tpu_torch.ops import _build, group as G, pairwise
from prrn_aln_tpu_torch.ops import seeded, spliced_h as SH, spliced_s as SS
from prrn_aln_tpu_torch.ops.window import stripe

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
# NVIDIA's data sheet (H100 SXM, at 700 W): device memory rate and the
# float32 rate outside the tensor cores
MEM_BPS = 3.35e12
F32_OPS = 67e12
# and the float64 rate outside the tensor cores
F64_OPS = 34e12
# phase 12's shapes: the DNA pair's length, the steps its carried chunks
# start at, the linear aligner's chunk; the protein pair's lengths and
# chunk starts
LONG_PAIR = {"dna_nt": 20000, "dna_starts": (0, 10001, 20480),
             "chunk": 2048, "prot": (1000, 1040),
             "prot_starts": (0, 777, 1536)}
# gene-prediction inputs: genome, query
ALN_CASES = {"mini": ("mini_gen.fa", "mini_pro.fa"),
             "win_single": ("cet10b9_win31401.fa", "ce13a1_unaligned.fa"),
             "win_msa": ("cet10b9_win31401.fa", "ce13a.msa")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median wall time on the card's stream of warm calls (CUDA events)."""
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


def profiled(fn, reps: int, word: str) -> list:
    """The ``torch.profiler`` averages of the kernels whose names hold
    ``word`` over ``reps`` warm calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if word in ev.key and getattr(ev, "device_time_total", 0)]
    if not evs:
        print(f"device_ms: no device time under {word!r} in "
              f"{[ev.key[:60] for ev in prof.key_averages()]}",
              file=sys.stderr, flush=True)
    return evs


def device_ms(fn, reps: int, word: str):
    """A kernel's own time a call on the card, without its wrapper's host
    work: the device time of the kernels whose names hold ``word``
    (``torch.profiler``), over ``reps`` warm calls; None where the
    profiler records none."""
    total = sum(ev.device_time_total for ev in profiled(fn, reps, word))
    return total / reps / 1e3 if total else None


def launch_ms(fn, reps: int, word: str):
    """A kernel's own time a launch: ``device_ms``'s device time over the
    launches the profiler recorded rather than the calls made (late in a
    long run it drops some, which a mean a call would count as zero);
    None where it records none."""
    evs = profiled(fn, reps, word)
    n = sum(ev.count for ev in evs)
    return sum(ev.device_time_total for ev in evs) / n / 1e3 if n else None


def queued_ms(launch, reps: int) -> float:
    """A kernel's own time a launch on the card: CUDA events around
    ``reps`` launches enqueued back to back, with no synchronisation
    between them, so that the card and not the host sets the pace (each
    launch's host work runs while the previous kernel does).  ``launch``
    enqueues the kernel alone and waits for nothing."""
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


def time_once_ms(fn) -> float:
    """One call on the card's stream (CUDA events), for the plain
    versions that take seconds: they have run once already by then."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound(nbytes: float, nops: float, f64_ops: float = 0) -> dict:
    """The least time the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its float operations over the f32 rate (and
    its f64 operations over the f64 rate).  No PyTorch call computes a
    banded DP, so there is no library time."""
    tb = nbytes / MEM_BPS * 1e3
    to = (nops / F32_OPS + f64_ops / F64_OPS) * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k2_bound(ins: dict, dirs: torch.Tensor) -> dict:
    """K2's bound over the member pairs it walks (each pair's real ones),
    with the reckoning over the padded pairs beside it.  A band cell: the
    C-channel profile product and six crg sums (a multiply and an add a
    channel or member pair, in f64) and the lane update (9 f32)."""
    plan = G.wavefront_plan(ins, nslot=dirs.shape[2])
    C = ins["CA"].shape[2]
    cells = [pairwise.band_cells(*(ins[x][b:b + 1].cpu().numpy()
                                   for x in ("la", "lb", "lw", "up")))
             for b in range(ins["CA"].shape[0])]
    nbytes = tensor_bytes(*ins.values()) + 4 * len(cells) + 2 * dirs.numel()

    def f64_ops(pairs):
        return sum(c * (2 * C + 12 * p) for c, p in zip(cells, pairs))

    real = bound(nbytes, 9 * sum(cells), f64_ops(plan["real_pairs"]))
    padded = bound(nbytes, 9 * sum(cells),
                   f64_ops([plan["padded_pairs"]] * len(cells)))
    return {**real, "bound_ms_padded": padded["bound_ms"]}


def k2_report(ins: dict, kw: dict, ms: float) -> dict:
    """What a timed K2 call walked: real and padded member pairs, steps,
    microseconds a step, the variant and its registers."""
    plan = G.wavefront_plan(ins, nslot=kw["nslot"], ls3=kw.get("ls3", False))
    return {"pairs": ins["CA"].shape[0],
            "real_member_pairs": plan["real_pairs"],
            "padded_member_pairs": plan["padded_pairs"],
            "nslot": kw["nslot"], "nsteps": kw["nsteps"],
            "us_per_step": ms * 1e3 / kw["nsteps"],
            "variant": plan["variant"], "smem_bytes": plan["smem_bytes"],
            **G.group_wavefront_attrs(kw.get("ls3", False), plan["variant"])}


def k1_launch(args: tuple, ms: float) -> dict:
    """K1's launch plan for these arguments, microseconds a step, and the
    plan's registers and spilled bytes."""
    a_batch, b_batch, la, lb, lw, up, mtx = args[:7]
    plan = pairwise.pairwise_plan(int((up - lw).max()) + 3, a_batch.shape[0],
                                  mtx.shape[0], a_batch.shape[1],
                                  b_batch.shape[1])
    steps = int((la + lb).max()) - 1
    return {"variant": plan["variant"], "lanes": plan["lanes"],
            "warps_a_pair": plan["warps"],
            "pairs_a_block": plan["pairs_per_block"], "steps": steps,
            "us_per_step": ms * 1e3 / steps,
            **pairwise.pairwise_attrs(plan, bool(args[11]))}


def k3_launch(args: tuple, max_iters: int, cnts: torch.Tensor,
              ms: float) -> dict:
    """K3's launch plan for these planes, microseconds a move of the
    longest walk, and the variant's registers and spilled bytes."""
    dirs = args[0]
    plan = G.traceback_plan(dirs.shape[1], dirs.shape[2], max_iters)
    moves = int(cnts.max())
    return {"variant": plan["variant"], "tile_rows": plan["tile_rows"],
            "width": plan["width"],
            "smem_bytes": plan["smem_bytes"], "longest_walk_moves": moves,
            "us_per_move": ms * 1e3 / max(moves, 1),
            **G.traceback_attrs(plan["variant"])}


def golden_rows(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        mt = re.match(r"\s*\d+ (.{1,61})\| (\S+)", line)
        if mt:
            rows.setdefault(mt.group(2), []).append(mt.group(1).rstrip())
    return {k: "".join(v) for k, v in rows.items()}


def pairwise_fixture_sets(dev):
    """The pairwise fixtures by alphabet and mode, as tensors on the
    card: yields (molc, local, cases, launch arguments)."""
    fx = json.loads((FIX / "pairwise_fixtures.json").read_text())
    mats = fx["matrices"]
    prot, _ = scoring.protein_matrix(AlnParams(pam=mats["protein_pam"]))
    dna, _ = scoring.dna_matrix(AlnParams(u=mats["dna_u"],
                                          n_mismatch=mats["dna_mismatch"]))
    for molc, mtx in ((1, prot), (2, dna)):
        for local in (False, True):
            cases = [c for c in fx["cases"]
                     if fx["seqs"][c["a"]]["molc"] == molc
                     and bool(c["lcl"] & 16) == local]
            a = [np.array(fx["seqs"][c["a"]]["codes"], np.int32)
                 for c in cases]
            b = [np.array(fx["seqs"][c["b"]]["codes"], np.int32)
                 for c in cases]
            n = len(cases)
            A = np.zeros((n, max(map(len, a))), np.int32)
            Bm = np.zeros((n, max(map(len, b))), np.int32)
            for i in range(n):
                A[i, :len(a[i])] = a[i]
                Bm[i, :len(b[i])] = b[i]
            wd = [stripe(len(x), len(y), c["sh"])
                  for x, y, c in zip(a, b, cases)]
            arrs = [A, Bm,
                    np.array([len(x) for x in a], np.int32),
                    np.array([len(y) for y in b], np.int32),
                    np.array([w.lw for w in wd], np.int32),
                    np.array([w.up for w in wd], np.int32),
                    mtx.astype(np.float32),
                    np.array([c["u"] for c in cases], np.float32),
                    np.array([c["v"] for c in cases], np.float32),
                    np.array([c["tgapf"] for c in cases], np.float32),
                    np.array([[c["lcl"] & 1, c["lcl"] & 2, c["lcl"] & 4,
                               c["lcl"] & 8] for c in cases], bool)]
            yield molc, local, cases, tuple(
                torch.as_tensor(x, device=dev) for x in arrs)


def phase_k1(dev) -> tuple:
    """K1 against its plain version; returns the bench batch's launch
    arguments and its band cells."""
    err = 0.0
    ncase = 0
    for molc, local, cases, args in pairwise_fixture_sets(dev):
        got = pairwise._launch_pairwise(*args, local)
        ref = pairwise._plain_pairwise(*args, local)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K1 != plain on fixtures molc={molc} "
                                 f"local={local}")
        want = np.array([c["score"] for c in cases])
        # the JAX package's own tolerance against the reference
        # (tests/test_pairwise_jax.py)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-5,
                                   atol=0.05)
        err = max(err, float((got - ref).abs().max()))
        ncase += len(cases)
    emit({"phase": "k1_fixtures", "cases": ncase, "max_abs_err": err})

    # bench.py's shape: 512 pairs of 512 x 512 at sh=-60
    rng = np.random.default_rng(0)
    B, L = 512, 512
    A = torch.as_tensor(rng.integers(3, 23, size=(B, L)).astype(np.int32),
                        device=dev)
    Bm = torch.as_tensor(rng.integers(3, 23, size=(B, L)).astype(np.int32),
                         device=dev)
    w = stripe(L, L, -60)
    full = lambda x, dt: torch.full((B,), x, dtype=dt, device=dev)  # noqa
    la = lb = full(L, torch.int32)
    lw, up = full(w.lw, torch.int32), full(w.up, torch.int32)
    prot, _ = scoring.protein_matrix(AlnParams(pam=150))
    mt = torch.as_tensor(prot, device=dev)
    u, v, tg = (full(x, torch.float32) for x in (2.0, 9.0, 1.0))
    exg = torch.zeros((B, 4), dtype=torch.bool, device=dev)
    kern = lambda: pairwise.pairwise_scores(A, Bm, la, lb, mt, u, v, tg,  # noqa
                                            exg, lw, up)
    plain = lambda: pairwise.wavefront_scores_ref(  # noqa
        A, Bm, la, lb, lw, up, mt, u, v, tg, exg, nslot=w.width,
        nsteps=2 * L - 1)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K1 != plain on the 512 x 512 batch")
    err = max(err, float((got - ref).abs().max()))
    ms = time_ms(kern, 7)
    plain_ms = time_ms(plain, 5)
    cells = B * pairwise.band_cells(np.array([L]), np.array([L]),
                                    np.array([w.lw]), np.array([w.up]))
    args = (A, Bm, la, lb, lw, up, mt, u, v, tg, exg, False)
    emit({"phase": "k1_bench", "pairs": B, "len": L, "sh": -60,
          "band_cells": cells, "ms": ms, "plain_ms": plain_ms,
          "gcups": cells / (ms * 1e6), "plain_gcups": cells / (plain_ms * 1e6),
          "max_abs_err": err, "k1_launch": k1_launch(args, ms)})
    return args[:11], cells


def phase_k2k3(dev) -> None:
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    gfix = json.loads((FIX / "galign_fixtures.json").read_text())
    ls3fix = json.loads((FIX / "galign_ls3.json").read_text())

    def build(fname, weighted):
        info = gfix["files"][fname]
        m = msa_from_strings(info["rows"], ab.PROTEIN, info["names"])
        if weighted:
            if m.many == 1:
                m.weight = np.array([1.0])
            elif m.many == 2:
                m.weight = np.array([0.5, 0.5])
            else:
                d = distance.msa_distance_matrix(m.codes)
                m.weight = tree.calc_seq_weights(tree.upgma(d, m.many))
        m.prepare(mtx.shape[0])
        return m

    def case_pairs(cases):
        out = []
        for c in cases:
            A, B = build(c["a"], "wa" in c), build(c["b"], "wa" in c)
            out.append((B, A) if c["swp"] else (A, B))
        return out

    rng = np.random.default_rng(0)

    def rand_msa(many, L):
        codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
        codes[rng.random((many, L)) < 0.08] = ab.GAP
        codes[:, 0] = ab.ALA + rng.integers(0, 20)
        m = Msa(codes=codes, molc=ab.PROTEIN,
                names=[f"s{i}" for i in range(many)],
                weight=rng.random(many) + 0.5)
        m.prepare(mtx.shape[0])
        return m

    batch32 = [(rand_msa(8, 384), rand_msa(8, 384)) for _ in range(32)]
    # real member counts 1-7 padded to 7, as the progressive merges pad
    mixed = [(rand_msa(a, 300), rand_msa(b, 310))
             for a, b in ((1, 7), (7, 1), (3, 4), (2, 2), (6, 5))]
    # members enough that the runs leave shared memory: the global variant
    wide = [(rand_msa(57, 300), rand_msa(2, 300)),
            (rand_msa(30, 310), rand_msa(1, 300))]
    sets = [("galign", case_pairs(gfix["cases"]), False, None, -60),
            ("galign_ls3", case_pairs(ls3fix["cases"]), True,
             [c["score"] for c in ls3fix["cases"]], -60),
            ("mixed_1to7_pad7", mixed, False, None, -60),
            ("global_57x2", wide, False, None, -300),
            ("batch32_8x384", batch32, False, None, -60)]
    err2 = 0.0
    err3 = 0
    timing = {}
    for name, pairs, ls3, want, sh in sets:
        an_pad = max(max(A.many, B.many) for A, B in pairs)
        if name.startswith("mixed"):
            an_pad = 7
        la_max = lb_max = G._bucket(max(max(A.length, B.length)
                                        for A, B in pairs))
        wd = [stripe(A.length, B.length, sh) for A, B in pairs]
        nslot = G._bucket(max(w.up - w.lw + 3 for w in wd), 128)
        nsteps = G._bucket(max(A.length + B.length + 1 for A, B in pairs),
                           256)
        items = [G._pack_inputs(A, B, mtx, 2.0, 9.0, w, an_pad, an_pad,
                                la_max, lb_max, spb=20.0,
                                ls=3 if ls3 else 1)
                 for (A, B), w in zip(pairs, wd)]
        ins = G.stack_inputs(items, dev)
        kw = dict(nslot=nslot, nsteps=nsteps, ls3=ls3)
        sk, dk, ok, _ = G.group_wavefront(ins, **kw)
        sr, dr, orf, _ = G.group_wavefront_ref(ins, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dr) and torch.equal(ok, orf)):
            raise AssertionError(f"K2 planes != plain on {name}")
        if not torch.equal(sk, sr):
            raise AssertionError(f"K2 scores != plain on {name}: max diff "
                                 f"{float((sk - sr).abs().max())}")
        variant = G.wavefront_plan(ins, nslot=nslot, ls3=ls3)["variant"]
        if variant != ("global" if name.startswith("global") else "shared"):
            raise AssertionError(f"K2 took the {variant} variant on {name}")
        err2 = max(err2, float((sk - sr).abs().max()))
        mi = 2 * (la_max + lb_max) + 4
        tb = (dk, ok, ins["la"], ins["lb"], ins["lw"])
        mk, ck = G.traceback(*tb, max_iters=mi)
        mr, cr = G.traceback_ref(*tb, max_iters=mi)
        torch.cuda.synchronize()
        if not (torch.equal(mk, mr) and torch.equal(ck, cr)):
            raise AssertionError(f"K3 moves != plain on {name}")
        err3 = max(err3, int((mk.int() - mr.int()).abs().max()))
        las = [A.length for A, _ in pairs]
        lbs = [B.length for _, B in pairs]
        if G._skls(mk, ck, las, lbs) != G._skls(mr, cr, las, lbs):
            raise AssertionError(f"SKLs differ on {name}")
        if want is not None:
            # reference ls=3 scores, at tests/test_double_affine.py's
            # tolerance
            np.testing.assert_allclose(sk.cpu().numpy(), want, rtol=2e-4,
                                       atol=0.05)
        emit({"phase": f"k2k3_{name}", "pairs": len(pairs),
              "an_pad": an_pad, "nslot": nslot, "nsteps": nsteps,
              "variant": variant, "planes_equal": True, "scores_equal": True,
              "skls_equal": True,
              "score_max_abs_err": float((sk - sr).abs().max())})
        if name in ("mixed_1to7_pad7", "global_57x2"):
            ms = time_ms(lambda: G.group_wavefront(ins, **kw), 5)
            emit({"phase": f"k2_time_{name}", "ms": ms,
                  **k2_report(ins, kw, ms)})
        if name == "batch32_8x384":
            timing["k2_ms"] = time_ms(lambda: G.group_wavefront(ins, **kw), 5)
            timing["k2"] = k2_report(ins, kw, timing["k2_ms"])
            timing["k2_bound"] = k2_bound(ins, dk)
            timing["k2_plain_ms"] = time_once_ms(
                lambda: G.group_wavefront_ref(ins, **kw))
            timing["k3_ms"] = time_ms(
                lambda: G.traceback(*tb, max_iters=mi), 7)
            timing["k3_launch"] = k3_launch(tb, mi, ck, timing["k3_ms"])
            timing["k3_plain_ms"] = time_ms(
                lambda: G.traceback_ref(*tb, max_iters=mi), 5)
    emit({"phase": "k2k3_bench", "shape": "32 pairs x (8 x 384)",
          "k2_max_abs_err": err2, "k3_max_abs_err": err3, **timing})


def phase_main() -> dict:
    want = (FIX / "jax_prrn_ce13a17_clean_R0.txt").read_text()
    golden = golden_rows((FIX / "golden_prrn_default7.txt").read_text())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("cold", "warm"):
            path = Path(tmp) / f"{run}.txt"
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = prrn_main(["-R", "0", str(FIX / "ce13a17_clean.fa"),
                            "-o", str(path), "--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
            text = path.read_text()
            if rc != 0:
                raise AssertionError(f"prrn_main returned {rc}")
            if text != want:
                raise AssertionError(f"{run} prrn output differs from "
                                     "jax_prrn_ce13a17_clean_R0.txt")
            rows = golden_rows(text)
            exact = sum(rows.get(k) == v for k, v in golden.items())
            if exact != len(golden) or list(rows) != list(golden):
                raise AssertionError(f"{exact}/{len(golden)} golden rows")
            for k in ("pairwise", "group_wavefront", "traceback"):
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"{run} run never launched {k}")
            out[run] = {"seconds": secs, "launches": counts}
            emit({"phase": f"prrn_{run}", "seconds": secs, "bytes": len(text),
                  "golden_rows_exact": exact, "launches": counts})
    return out


def capture_main_path() -> dict:
    """Run ``prrn -R 0`` once more with recorders at the kernels' launch
    points; returns each kernel's calls as (args, kwargs, output)."""
    real = {"pairwise": (pairwise, "_launch_pairwise"),
            "group_wavefront": (G, "group_wavefront"),
            "traceback": (G, "traceback")}
    calls = {name: [] for name in real}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append((args, kwargs, out))
            return out
        return call

    saved = {name: getattr(mod, attr) for name, (mod, attr) in real.items()}
    for name, (mod, attr) in real.items():
        setattr(mod, attr, recorder(name, saved[name]))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "capture.txt"
            prrn_main(["-R", "0", str(FIX / "ce13a17_clean.fa"), "-o",
                       str(path), "--device", "cuda"])
            if path.read_text() != (FIX / "jax_prrn_ce13a17_clean_R0.txt"
                                    ).read_text():
                raise AssertionError("capture run output differs")
    finally:
        for name, (mod, attr) in real.items():
            setattr(mod, attr, saved[name])
    return calls


def phase_main_shapes() -> tuple[dict, dict, dict]:
    """Every kernel call of the main path against its plain version on
    the card, on the same inputs; times at the main path's shapes (K1:
    its one call; K2 and K3: the call with the most real member pairs
    times steps)."""
    calls = capture_main_path()
    k1_err = 0.0
    for args, _, out in calls["pairwise"]:
        ref = pairwise._plain_pairwise(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError("K1 != plain on the main path's call")
        k1_err = max(k1_err, float((out - ref).abs().max()))
    k2_err = 0.0
    for (ins,), kw, (score, dirs, opens, _) in calls["group_wavefront"]:
        sr, dr, orf, _ = G.group_wavefront_ref(ins, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dirs, dr) and torch.equal(opens, orf)):
            raise AssertionError("K2 planes != plain on a main-path call")
        if not torch.equal(score, sr):
            raise AssertionError("K2 scores != plain on a main-path call")
        k2_err = max(k2_err, float((score - sr).abs().max()))
    k3_err = 0.0
    for args, kw, (moves, cnts) in calls["traceback"]:
        mr, cr = G.traceback_ref(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(moves, mr) and torch.equal(cnts, cr)):
            raise AssertionError("K3 moves != plain on a main-path call")
        k3_err = max(k3_err, float((moves.int() - mr.int()).abs().max()))

    k1_args = calls["pairwise"][0][0]
    a_batch, _, la, lb, lw, up = k1_args[:6]
    k1_cells = pairwise.band_cells(*(x.cpu().numpy() for x in (la, lb, lw,
                                                               up)))
    # a band cell: 3 adds or subtractions and 6 maxima over H, F and G
    k1 = {"max_abs_err": k1_err,
          "ms": time_ms(lambda: pairwise._launch_pairwise(*k1_args), 7),
          "device_ms": device_ms(lambda: pairwise._launch_pairwise(*k1_args),
                                 7, "pairwise"),
          "plain_ms": time_ms(lambda: pairwise._plain_pairwise(*k1_args), 5),
          **bound(tensor_bytes(*(x for x in k1_args
                                 if isinstance(x, torch.Tensor)))
                  + 4 * a_batch.shape[0], 9 * k1_cells)}

    def work(call):
        # steps times the most real member pairs of a pair of the call
        (ins,), kw, _ = call
        plan = G.wavefront_plan(ins, nslot=kw["nslot"])
        return max(plan["real_pairs"]) * kw["nsteps"], kw["nsteps"]

    k = max(range(len(calls["group_wavefront"])),
            key=lambda i: work(calls["group_wavefront"][i]))
    (ins,), kw, (_, dirs, _, _) = calls["group_wavefront"][k]
    ms = time_ms(lambda: G.group_wavefront(ins, **kw), 7)
    k2 = {"max_abs_err": k2_err, "ms": ms,
          "plain_ms": time_once_ms(lambda: G.group_wavefront_ref(ins, **kw)),
          **k2_bound(ins, dirs)}
    # every K2 call of the run, timed on its own inputs
    each = [time_ms(lambda c=c: G.group_wavefront(c[0][0], **c[1]), 3)
            for c in calls["group_wavefront"]]
    emit({"phase": "k2_time_ce13a17_widest", "ms": ms,
          "run_calls": len(each), "run_sum_ms": sum(each),
          "run_max_ms": max(each),
          "run_ms": each,
          "run_real_pairs": [max(G.wavefront_plan(
              c[0][0], nslot=c[1]["nslot"])["real_pairs"])
              for c in calls["group_wavefront"]],
          "run_nsteps": [c[1]["nsteps"] for c in calls["group_wavefront"]],
          **k2_report(ins, kw, ms)})
    tb_args, tb_kw, (_, cnts) = calls["traceback"][k]
    # a move reads one dirs and one opens byte and writes one move byte
    k3 = {"max_abs_err": k3_err,
          "ms": time_ms(lambda: G.traceback(*tb_args, **tb_kw), 7),
          "device_ms": device_ms(lambda: G.traceback(*tb_args, **tb_kw), 7,
                                 "traceback"),
          "plain_ms": time_ms(lambda: G.traceback_ref(*tb_args, **tb_kw), 5),
          **bound(3 * int(cnts.sum()) + 4 * cnts.numel(), 0)}
    emit({"phase": "main_path_kernels",
          "calls": {name: len(c) for name, c in calls.items()},
          "k1_launch": k1_launch(k1_args, k1["ms"]),
          "k3_launch": k3_launch(tb_args, tb_kw["max_iters"], cnts, k3["ms"]),
          "k1_shape": {"pairs": a_batch.shape[0],
                       "band_cells": pairwise.band_cells(
                           *(x.cpu().numpy() for x in (la, lb, lw, up)))},
          "k2_shape": {"an": ins["wa"].shape[1], "bn": ins["wb"].shape[1],
                       "la": int(ins["la"][0]), "lb": int(ins["lb"][0]),
                       **kw},
          "k1": k1, "k2": k2, "k3": k3, "planes_equal": True,
          "moves_equal": True})
    return k1, k2, k3


@contextlib.contextmanager
def forest_probe():
    """Recorders around the forest path's stages and kernel launch points
    for one run: stage walls (host clock between synchronisations), each
    kernel's CUDA events, the edge list, the forest, the jobs of every
    ``group_align_batch`` launch and the arguments of the edge pass."""
    rec = {"walls": collections.Counter(), "refines": [], "events":
           collections.defaultdict(list), "jobs": [], "edge_args": None,
           "k2_widest": None}

    def timed(label, fn, keep=None):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rec["walls"][label] += secs
            if keep:
                keep(args, out, secs)
            return out
        return call

    def evented(name, fn, keep_args=False):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec["events"][name].append((start, end))
            if keep_args:
                rec["edge_args"] = (name, args)
            return out
        return call

    def widest(fn):
        # the K2 call with the most real member pairs in one pair, with
        # its inputs and output
        def call(ins, **kw):
            out = fn(ins, **kw)
            real = max(G.wavefront_plan(ins, nslot=kw["nslot"])["real_pairs"])
            if rec["k2_widest"] is None or real > rec["k2_widest"][0]:
                rec["k2_widest"] = (real, ins, kw, out)
            return out
        return call

    def keep_as(key):
        return lambda args, out, secs: rec.__setitem__(key, out)

    def jobs(fn):
        def call(pairs, *args, **kwargs):
            rec["jobs"].append(len(pairs))
            return fn(pairs, *args, **kwargs)
        return call

    patches = [
        (kmer, "kmer_distance_matrix", lambda f: timed("kmer", f)),
        (slforest, "candidate_edges",
         lambda f: timed("edges_with_kmer", f, keep_as("edges"))),
        (slforest, "build_forest",
         lambda f: timed("build_forest", f, keep_as("forest"))),
        (pipeline, "progressive_msa_forest",
         lambda f: timed("forest_merges", f)),
        (progressive, "group_align_batch", jobs),
        (pipeline, "update_msa", lambda f: timed("update_msa", f)),
        (pipeline, "cut_in", lambda f: timed("cut_in", f)),
        (pipeline, "refine_msa", lambda f: timed(
            "refine", f, lambda args, out, secs: rec["refines"].append(
                (args[0].many, secs)))),
        (pairwise, "_launch_pairwise",
         lambda f: evented("pairwise", f, True)),
        (pairwise, "_launch_rows",
         lambda f: evented("pairwise_rows", f, True)),
        (G, "group_wavefront",
         lambda f: widest(evented("group_wavefront", f))),
        (G, "traceback", lambda f: evented("traceback", f)),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, wrap in patches:
        setattr(mod, attr, wrap(getattr(mod, attr)))
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def tree_shape(node):
    """A forest tree as nested (left, right) pairs of leaf ids."""
    if node.left is None:
        return node.tid
    return (tree_shape(node.left), tree_shape(node.right))


def probe_summary(rec) -> dict:
    torch.cuda.synchronize()
    trees, singles = rec["forest"]
    return {"edges": len(rec["edges"]),
            "tree_sizes": [t.ndesc for t in trees], "singles": singles,
            "batch_jobs": rec["jobs"],
            "stage_wall_s": dict(rec["walls"]),
            "refine_calls": [{"members": m, "seconds": x}
                             for m, x in rec["refines"]],
            "kernel_ms": {k: sum(a.elapsed_time(b) for a, b in ev)
                          for k, ev in rec["events"].items()},
            "kernel_calls": {k: len(ev) for k, ev in rec["events"].items()}}


def run_forest(argv, fused: bool):
    """One ``prrn`` run of the forest path on the card under the probe;
    returns (output, seconds, launches, probe record)."""
    with tempfile.TemporaryDirectory() as tmp, forest_probe() as rec:
        path = Path(tmp) / "forest.txt"
        if fused:
            os.environ["PRRN_PW_FUSED"] = "1"
        try:
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = prrn_main([*argv, "-o", str(path), "--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
        finally:
            os.environ.pop("PRRN_PW_FUSED", None)
        if rc != 0:
            raise AssertionError(f"prrn_main returned {rc}")
        return path.read_text(), secs, counts, rec


def phase_forest() -> tuple[dict, tuple]:
    """``prrn -R 0`` on fam19 through the kernels: cold, then (warm)
    under ``PRRN_PW_FUSED=1``.  Returns the launches of both runs and
    the edge pass's launch arguments."""
    want = (FIX / "jax_prrn_fam19_R0.txt").read_text()
    argv = ["-R", "0", str(FIX / "fam19.fa")]
    runs = {}
    for run in ("cold", "fused"):
        text, secs, counts, rec = run_forest(argv, fused=run == "fused")
        if text != want:
            raise AssertionError(f"{run} prrn output on fam19 differs from "
                                 "jax_prrn_fam19_R0.txt")
        need = ("pairwise_rows" if run == "fused" else "pairwise",
                "group_wavefront", "traceback")
        for k in need:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"{run} forest run never launched {k}")
        if run == "fused" and counts.get("pairwise", 0) != 0:
            raise AssertionError("K1 was launched under PRRN_PW_FUSED=1")
        if rec["edge_args"][0] != need[0]:
            raise AssertionError(f"{run}: the edge pass went to "
                                 f"{rec['edge_args'][0]}")
        runs[run] = (counts, rec)
        emit({"phase": f"prrn_forest_{run}", "seconds": secs,
              "bytes": len(text), "launches": counts,
              **probe_summary(rec)})

    # the switch must leave the edge list and the forest as they were
    off, on = runs["cold"][1], runs["fused"][1]
    e_off = [(e.u, e.v) for e in off["edges"]]
    e_on = [(e.u, e.v) for e in on["edges"]]
    if e_off != e_on:
        raise AssertionError(
            f"edge lists differ under the switch: only off "
            f"{sorted(set(e_off) - set(e_on))}, only on "
            f"{sorted(set(e_on) - set(e_off))}")
    order = [sorted(range(len(r["edges"])), key=lambda k: r["edges"][k].dist)
             for r in (off, on)]
    if order[0] != order[1]:
        swapped = [(e_off[a], e_off[b]) for a, b in zip(*order) if a != b]
        raise AssertionError(f"edges swap order under the switch: {swapped}")
    shapes = [[tree_shape(t) for t in r["forest"][0]] for r in (off, on)]
    if shapes[0] != shapes[1] or off["forest"][1] != on["forest"][1]:
        raise AssertionError("the forest differs under the switch")
    dmax = max(abs(a.dist - b.dist)
               for a, b in zip(off["edges"], on["edges"]))
    emit({"phase": "prrn_forest_switch", "edges_equal": True,
          "edge_order_equal": True, "forest_equal": True,
          "max_edge_dist_diff": dmax})
    k3_ms = sum(a.elapsed_time(b)
                for a, b in runs["cold"][1]["events"]["traceback"])
    return ({"cold": runs["cold"][0], "fused": runs["fused"][0],
             "cold_k3_ms": k3_ms},
            runs["fused"][1]["edge_args"][1], runs["cold"][1]["k2_widest"])


def phase_fam19_k2(widest) -> dict:
    """K2 on the call of fam19's forest run with the most real member
    pairs (its last refinement): bit for bit against the plain version,
    and timed."""
    real, ins, kw, (score, dirs, opens, _) = widest
    sr, dr, orf, _ = G.group_wavefront_ref(ins, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dirs, dr) and torch.equal(opens, orf)
            and torch.equal(score, sr)):
        raise AssertionError("K2 != plain on fam19's widest call")
    ms = time_ms(lambda: G.group_wavefront(ins, **kw), 5)
    out = {"max_abs_err": 0.0, "ms": ms,
           "plain_ms": time_once_ms(lambda: G.group_wavefront_ref(ins, **kw)),
           **k2_bound(ins, dirs)}
    emit({"phase": "k2_time_fam19_widest", "la": int(ins["la"][0]),
          "lb": int(ins["lb"][0]), "equals_plain": True, **out,
          **k2_report(ins, kw, ms)})
    return out


def ulp_diffs(a: torch.Tensor, b: torch.Tensor, la, lb, u, v) -> dict:
    """Largest difference of two score vectors in f32 ulp: of the score
    itself, and at the DP's scale, the larger of the score and the
    boundary penalty v + u * max(la, lb) that every score is a
    difference of."""
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    diff = np.abs(a64 - b64)
    mag = np.maximum(np.abs(a64), np.abs(b64))
    pen = (v.double() + u.double() * torch.maximum(la, lb).double()
           ).cpu().numpy()
    return {"max_abs_diff": float(diff.max()),
            "max_ulp_of_score": float(
                (diff / np.spacing(mag.astype(np.float32))).max()),
            "max_ulp_at_dp_scale": float((diff / np.spacing(
                np.maximum(mag, pen).astype(np.float32))).max())}


def k1f_launch(args: tuple, nlane: int, ms: float, dms) -> dict:
    """K1f's launch plan for these arguments, microseconds a row (through
    the wrapper and on the device), and the plan's registers and spilled
    bytes."""
    a_batch, b_batch, la = args[:3]
    plan = pairwise.rows_plan(nlane, a_batch.shape[0], args[6].shape[0],
                              a_batch.shape[1], b_batch.shape[1])
    rows = int(la.max())
    return {"variant": plan["variant"], "lanes_a_thread": plan["lanes"],
            "warps_a_pair": plan["warps"],
            "pairs_a_block": plan["pairs_per_block"], "rows": rows,
            "us_per_row": ms * 1e3 / rows,
            "device_us_per_row": None if dms is None else dms * 1e3 / rows,
            **pairwise.rows_attrs(plan)}


def k1f_against_k1(name: str, args: tuple, cells: int, lw0=None,
                   nlane=None) -> dict:
    """K1f on one batch: bit for bit against its plain version, within 4
    ulp (at the DP's scale) of K1, and both kernels' times."""
    la, lb, lw, up = args[2:6]
    u, v = args[7:9]
    if lw0 is None:
        lw0 = int(lw.min())
        nlane = int(up.max()) - lw0 + 1
    rows = lambda: pairwise._launch_rows(*args, lw0, nlane)   # noqa: E731
    plain = lambda: pairwise._plain_rows(*args, lw0, nlane)   # noqa: E731
    wave = lambda: pairwise._launch_pairwise(*args, False)    # noqa: E731
    got, ref, k1 = rows(), plain(), wave()
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K1f != plain on {name}: max diff "
                             f"{float((got - ref).abs().max())}")
    ulps = ulp_diffs(got, k1, la, lb, u, v)
    if ulps["max_ulp_at_dp_scale"] > 4:
        raise AssertionError(f"K1f differs from K1 on {name}: {ulps}")
    # the free-end-gap flags as bytes already: the launch then enqueues
    # K1f alone
    exg_u8 = args[10].to(torch.uint8)
    queued = lambda: pairwise._launch_rows(    # noqa: E731
        *args[:10], exg_u8, lw0, nlane)
    out = {"max_abs_err": float((got - ref).abs().max()),
           "ms": time_ms(rows, 7), "device_ms": queued_ms(queued, 20),
           "k1_ms": time_ms(wave, 7), "plain_ms": time_ms(plain, 3),
           # a band cell: as K1, 3 adds or subtractions and 6 maxima
           **bound(tensor_bytes(*args) + 4 * args[0].shape[0], 9 * cells)}
    emit({"phase": f"k1f_{name}", "pairs": args[0].shape[0],
          "lanes": nlane, "lw0": lw0, "rows": int(la.max()),
          "band_cells": cells, "equals_plain": True, "vs_k1": ulps,
          "gcups": cells / (out["ms"] * 1e6),
          "k1_gcups": cells / (out["k1_ms"] * 1e6),
          "k1f_launch": k1f_launch(args, nlane, out["ms"], out["device_ms"]),
          "k1_launch": k1_launch((*args, False), out["k1_ms"]), **out})
    return out


def phase_k1f(dev, bench_args, bench_cells, edge_args) -> dict:
    """K1f against its plain version and against K1; returns its entry
    for the kernels line (the fam19 edge batch)."""
    ncase = 0
    for molc, local, cases, args in pairwise_fixture_sets(dev):
        if local:
            continue                 # the row sweep has no local mode
        lw0 = int(args[4].min())
        nlane = int(args[5].max()) - lw0 + 1
        got = pairwise._launch_rows(*args, lw0, nlane)
        ref = pairwise._plain_rows(*args, lw0, nlane)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K1f != plain on fixtures molc={molc}")
        want = np.array([c["score"] for c in cases])
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-5,
                                   atol=0.05)
        ncase += len(cases)
    emit({"phase": "k1f_fixtures", "cases": ncase, "max_abs_err": 0.0,
          "equals_plain": True})
    k1f_against_k1("bench", bench_args, bench_cells)
    # the edge pass's own packing (lw0, nlane), as the wrapper launched it
    lw0, nlane = edge_args[11:13]
    edge_args = edge_args[:11]
    cells = pairwise.band_cells(*(x.cpu().numpy() for x in edge_args[2:6]))
    return k1f_against_k1("fam19_edges", edge_args, cells, lw0, nlane)


def write_family64(path: Path) -> None:
    """64 proteins: 8 unrelated random ancestors of 150-250 residues, 8
    descendants each with 10-20 % substitutions and a few short indels."""
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    out = []
    for f in range(8):
        anc = aa[rng.integers(0, 20, int(rng.integers(150, 251)))]
        for d in range(8):
            seq = anc.copy()
            hit = rng.random(len(seq)) < rng.uniform(0.10, 0.20)
            seq[hit] = aa[rng.integers(0, 20, int(hit.sum()))]
            seq = list(seq)
            for _ in range(int(rng.integers(2, 5))):
                at = int(rng.integers(1, len(seq) - 6))
                k = int(rng.integers(1, 6))
                if rng.random() < 0.5:
                    del seq[at:at + k]
                else:
                    seq[at:at] = list(aa[rng.integers(0, 20, k)])
            out.append(f">fam{f}_{d}\n{''.join(seq)}\n")
    path.write_text("".join(out))


def phase_forest_shape() -> None:
    """A family the forest path is for, timing only (no golden): wide
    enough for the device k-mer pass, run without refinement."""
    with tempfile.TemporaryDirectory() as tmp:
        fa = Path(tmp) / "family64.fa"
        write_family64(fa)
        text, secs, counts, rec = run_forest(["-R", "0", "-I", "0", str(fa)],
                                             fused=False)
    rows = golden_rows(text)
    if len(rows) != 64 or len({len(r) for r in rows.values()}) != 1:
        raise AssertionError(f"forest_shape: {len(rows)} rows in the output")
    for k in ("pairwise", "group_wavefront", "traceback"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"forest_shape never launched {k}")
    emit({"phase": "forest_shape", "sequences": 64, "flags": "-R 0 -I 0",
          "columns": len(next(iter(rows.values()))), "seconds": secs,
          "launches": counts, **probe_summary(rec)})


def run_aln(argv) -> tuple[str, float, dict]:
    """One ``aln`` run on the card: its output, seconds and launches."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "aln.txt"
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = aln_main([*argv, "-o", str(path), "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"aln_main returned {rc}")
        return path.read_text(), secs, counts


def phase_aln() -> dict:
    """``aln -yl2`` on the three gene-prediction inputs, cold and warm."""
    out = {}
    for name, (g, q) in ALN_CASES.items():
        want = (FIX / f"jax_aln_yl2_{name}.txt").read_text()
        for run in ("cold", "warm"):
            text, secs, counts = run_aln(["-yl2", str(FIX / g),
                                          str(FIX / q)])
            if text != want:
                raise AssertionError(f"{run} aln -yl2 on {name} differs from "
                                     f"jax_aln_yl2_{name}.txt")
            for k in ("spliced_h_wave", "spliced_h_walk"):
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"{run} aln on {name} never "
                                         f"launched {k}")
            out[(name, run)] = counts
            emit({"phase": f"aln_yl2_{name}_{run}", "seconds": secs,
                  "bytes": len(text), "launches": counts})
    mini = [str(FIX / f) for f in ALN_CASES["mini"]]
    text, _, _ = run_aln(["-yl2", "-O", "5", *mini])
    if text != (FIX / "aln_H_mini_O5.txt").read_text():
        raise AssertionError("aln -yl2 -O 5 on mini differs from "
                             "aln_H_mini_O5.txt")
    text, _, _ = run_aln(["-yl2", "-O", "1", *mini])
    if text != (FIX / "jax_aln_yl2_mini.txt").read_text():
        raise AssertionError("aln -yl2 -O 1 on mini differs from "
                             "jax_aln_yl2_mini.txt")
    # the reference's -O 1 golden: every line but the Score line, as the
    # JAX package's own test holds it (tests/test_spliced_h.py)
    gold = (FIX / "aln_H_mini_O1.txt").read_text().splitlines()
    ours = text.splitlines()
    if len(ours) != len(gold) or any(
            o != g for o, g in zip(ours, gold) if not g.startswith("Score =")):
        raise AssertionError("aln -yl2 -O 1 on mini differs from "
                             "aln_H_mini_O1.txt")
    emit({"phase": "aln_yl2_mini_O5_O1", "O5_equal": True, "O1_equal": True})
    return out


def capture_aln(argv) -> tuple[dict, str, float]:
    """Run ``aln`` once with recorders at K4's and K4w's launch points;
    returns their calls as (args, output), the output and the seconds."""
    calls = {"sweep": [], "walk": []}
    real = {"sweep": SH._launch_sweep, "walk": SH._launch_walk}

    def recorder(name):
        def call(*args):
            out = real[name](*args)
            calls[name].append((args, out))
            return out
        return call

    SH._launch_sweep, SH._launch_walk = recorder("sweep"), recorder("walk")
    try:
        text, secs, _ = run_aln(argv)
    finally:
        SH._launch_sweep, SH._launch_walk = real["sweep"], real["walk"]
    if len(calls["sweep"]) != 1 or len(calls["walk"]) != 1:
        raise AssertionError(f"expected one K4 and one K4w call, got "
                             f"{len(calls['sweep'])} and "
                             f"{len(calls['walk'])}")
    return calls, text, secs


def k4_ops(ins: SH.SweepInputs) -> int:
    """Float operations the sweep's recurrence needs on these inputs
    (counted from sweep_h_ref's wave body): 24 a band cell (diagonal,
    vertical and horizontal candidates, their maxima), 55 an acceptor
    phase merged (4 candidates of 8 adds, the sj and lane maxima), 24 a
    donor phase pushed (3 lanes of threshold, value and rank compares)."""
    tab = ins.tab.cpu().numpy()
    M, N = ins.M, ins.N
    p5, p3 = tab[:N, 2], tab[:N, 3]
    acc = np.concatenate([[0], np.cumsum((p3 != -2) + (p3 == 2))])
    don = np.concatenate([[0], np.cumsum((p5 != -2) + (p5 == 2))])
    m = np.arange(1, M + 1)
    lo = np.maximum(3 * m + ins.lw, 1)
    hi = np.minimum(3 * m + ins.up, N)
    ok = hi >= lo
    cells = int(np.where(ok, hi - lo + 1, 0).sum())
    hi1 = np.minimum(hi, N - 1)
    sites = ok & (hi1 >= lo) & ((m < M) | (not ins.a_exgr))
    lo_c = np.clip(lo, 0, N)
    hi_c = np.clip(hi1 + 1, 0, N)
    n_acc = int(np.where(sites, acc[hi_c] - acc[lo_c], 0).sum())
    n_don = int(np.where(sites, don[hi_c] - don[lo_c], 0).sum())
    return 24 * cells + 55 * n_acc + 24 * n_don


def k4_bounds(ins, sw, wk) -> tuple[dict, dict]:
    ins_bytes = tensor_bytes(*(v for v in vars(ins).values()
                               if isinstance(v, torch.Tensor)))
    k4 = bound(ins_bytes + tensor_bytes(*sw), k4_ops(ins))
    # a walk step reads its ev and jd words and at most one more ev word
    k4w = bound(12 * wk.steps + 8 * len(wk.knots) + 16, 0)
    return k4, k4w


def k4w_launch(wargs: tuple, wk, ms: float, dms) -> dict:
    """K4w's launch plan for these planes, microseconds a step (through
    the wrapper and on the device), the walk's reads of ev from the ring
    and from device memory, and the kernel's registers and spilled
    bytes."""
    SH._launch_walk(*wargs)
    reads = dict(SH.WALK_READS)
    plan = SH.walk_plan(*wargs[0].shape)
    steps = max(wk.steps, 1)
    return {"variant": plan["variant"], "ring_waves": plan["depth"],
            "rows_a_slot": plan["rows"], "stagers": plan["stagers"],
            "walk_steps": wk.steps, "ring_reads": reads["ring"],
            "device_reads": reads["device"], "us_per_step": ms * 1e3 / steps,
            "device_us_per_step": None if dms is None else dms * 1e3 / steps,
            **SH.spliced_h_walk_attrs()}


def k4_launch(ins: SH.SweepInputs, ms: float) -> dict:
    """K4's launch plan for these inputs, microseconds a wave, and the
    chosen variant's registers and spilled bytes."""
    plan = SH.launch_plan(ins.M + 1, ins.rlmt - ins.llmt + 1)
    return {"variant": plan["variant"], "clusters": plan["clusters"],
            "ctas": plan["ctas"], "rows_a_cta": plan["rows"],
            "us_per_wave": ms * 1e3 / ins.waves,
            **SH.spliced_h_wave_attrs(plan["variant"])}


def phase_k4() -> dict:
    """K4 and K4w against their plain versions on the card, on the inputs
    ``aln -yl2`` gives them; times (CUDA events).  The plain sweep runs
    on mini and on the window x ce13a.msa, not on the window x ce13a1."""
    out = {}
    for name, (g, q) in ALN_CASES.items():
        calls, text, _ = capture_aln(["-yl2", str(FIX / g), str(FIX / q)])
        if text != (FIX / f"jax_aln_yl2_{name}.txt").read_text():
            raise AssertionError(f"capture run on {name} differs")
        (ins,), sw = calls["sweep"][0]
        wargs, wk = calls["walk"][0]
        plain_ms = err = None
        if name != "win_single":
            out_ref = []
            plain_ms = time_once_ms(
                lambda: out_ref.append(SH.sweep_h_ref(ins)))
            ref = out_ref[0]
            for field in SH.Sweep._fields:
                if not torch.equal(getattr(sw, field), getattr(ref, field)):
                    raise AssertionError(f"K4 {field} != plain on {name}")
            err = max(float((sw.V - ref.V).abs().max()),
                      float((sw.bandV - ref.bandV).abs().max()))
        t0 = time.perf_counter()
        wref = SH.walk_h_ref(*wargs)
        walk_plain_ms = (time.perf_counter() - t0) * 1e3
        if wref != wk:
            raise AssertionError(f"K4w knots != plain on {name}")
        b4, b4w = k4_bounds(ins, sw, wk)
        k4 = {"max_abs_err": err, "ms": time_ms(
            lambda: SH._launch_sweep(ins), 5), "plain_ms": plain_ms, **b4}
        walk = lambda: SH._launch_walk(*wargs)        # noqa: E731
        k4w = {"max_abs_err": 0.0, "ms": time_ms(walk, 7),
               "device_ms": queued_ms(lambda: SH._enqueue_walk(*wargs), 20),
               "plain_ms": walk_plain_ms, **b4w}
        emit({"phase": f"k4_{name}", "waves": ins.waves, "rows": ins.M + 1,
              "genome": ins.N, "band_cells": ins.band_cells,
              "planes_equal": plain_ms is not None,
              "band_equal": plain_ms is not None, "knots_equal": True,
              "knots": len(wk.knots), "walk_steps": wk.steps,
              "k4": k4, "k4_launch": k4_launch(ins, k4["ms"]), "k4w": k4w,
              "k4w_launch": k4w_launch(wargs, wk, k4w["ms"],
                                       k4w["device_ms"])})
        out[name] = (k4, k4w)
    return out


# the plans phase_k4_long_introns holds to the plain version: the
# default (the cluster variant), the global variant and the chained
# variant forced onto 2 clusters of 3 CTAs
K4_LONG_INTRON_PLANS = {"cluster": {}, "global": {},
                        "chained": dict(clusters=2, ctas=3)}


def k4_chained_entry(lp: dict, long_introns: dict) -> dict:
    """The kernels line's entry of K4's chained variant: its launches in
    ``aln -yl2`` on lp3500 (warm), its time and bound there; held to the
    global variant on both long proteins and to the plain version on the
    long-intron gene under a forced plan (whose plain time, on a CPU copy
    of the inputs, is its plain_ms)."""
    big = lp["lp3500"]
    return {"name": "spliced_h_wave_chained", "route": "cuda",
            "source": "prrn_aln_tpu_torch/csrc/spliced_h_wave.cu",
            "replaces": "prrn_aln_tpu/ops/pallas_spliced_h.py:201",
            "launches": big["walls"]["warm"]["launches"]["spliced_h_wave"],
            "max_abs_err": max(long_introns["chained"]["max_abs_err"],
                               *(r["max_abs_err"] for r in lp.values())),
            "ms": big["k4_ms"],
            "plain_ms": long_introns["plain_cpu_ms"],
            "plain_ms_on": "long_intron_gene, CPU",
            **big["k4_bound"], "us_per_wave": big["k4_us_per_wave"],
            "global_ms": big["k4_global_ms"], "plan": big["k4_launch"],
            "long_introns_forced": long_introns["chained"],
            "lp2100": {k: lp["lp2100"][k] for k in (
                "k4_ms", "k4_us_per_wave", "k4_global_ms", "k4_launch")}}


def phase_k4_long_introns() -> dict:
    """The penalty tail's recheck: fwd2h on the long-intron gene
    (``long_intron_gene``: introns of 879 and 1,187 nt, lengths at which
    a correctly rounded log tail differs from the scan engine's), K4's
    three variants (``K4_LONG_INTRON_PLANS``) against the plain version,
    bit for bit (on a CPU copy of the inputs: the penalty table by length
    is one of them)."""
    from prrn_aln_tpu_torch.splice.hapi import spliced_align_h
    got = []
    real = SH._launch_sweep

    def rec(ins, plan=None):
        got.append((ins, real(ins, plan)))
        return got[-1][1]

    SH._launch_sweep = rec
    try:
        spliced_align_h(*long_intron_gene(), device="cuda")
    finally:
        SH._launch_sweep = real
    (ins, sw), = got
    cpu = dataclasses.replace(ins, **{
        k: v.cpu() for k, v in vars(ins).items()
        if isinstance(v, torch.Tensor)})
    t0 = time.perf_counter()
    ref = SH.sweep_h_ref(cpu)
    plain_cpu_ms = (time.perf_counter() - t0) * 1e3
    MR, npen = ins.M + 1, ins.rlmt - ins.llmt + 1
    out = {"rows": MR, "waves": ins.waves, "genome": ins.N,
           "introns": list(LONG_INTRONS), "plain_cpu_ms": plain_cpu_ms,
           "default_plan": SH.sweep_plan(MR, npen)["variant"]}
    for variant, kw in K4_LONG_INTRON_PLANS.items():
        plan = SH.sweep_plan(MR, npen, variant=variant, **kw)
        got_v = SH._launch_sweep(ins, plan)
        err = k4_err(SH.Sweep(*(x.cpu() for x in got_v)), ref)
        for field in SH.Sweep._fields:
            if not torch.equal(getattr(got_v, field).cpu(),
                               getattr(ref, field)):
                raise AssertionError(f"K4 {variant} {field} != plain on the "
                                     "long-intron gene")
        ms = time_ms(lambda p_=plan: SH._launch_sweep(ins, p_), 5)
        out[variant] = {
            "planes_equal": True, "max_abs_err": err, "ms": ms,
            "plan": {k: plan[k] for k in ("clusters", "ctas", "rows")},
            **SH.spliced_h_wave_attrs(variant)}
    emit({"phase": "k4_long_introns", **out})
    return out


def write_fasta(path: Path, name: str, seq: str) -> str:
    path.write_text(f">{name}\n" + "\n".join(
        seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return str(path)


def phase_flagship() -> None:
    """The flagship's shape, timing only: a 34.9 kb genome holding the
    2.3 kb CET10B9 window at 31,400 in uniform random flanks, against
    the 7-member ce13a.msa profile."""
    rng = np.random.default_rng(0)
    win = pio.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()

    def flank(k):
        return "".join(np.array(list("ACGT"))[rng.integers(0, 4, k)])

    genome = flank(31400) + win + flank(34900 - 31400 - len(win))
    with tempfile.TemporaryDirectory() as tmp:
        path = write_fasta(Path(tmp) / "flagship_shape.fa", "flagship_shape",
                           genome)
        calls, text, secs = capture_aln(["-yl2", path,
                                         str(FIX / "ce13a.msa")])
    (ins,), sw = calls["sweep"][0]
    wargs, wk = calls["walk"][0]
    ms = time_ms(lambda: SH._launch_sweep(ins), 3)
    wms = time_ms(lambda: SH._launch_walk(*wargs), 5)
    wdms = queued_ms(lambda: SH._enqueue_walk(*wargs), 20)
    exons = "".join(line[3:] for line in text.splitlines()
                    if line.startswith(";C "))
    b4, b4w = k4_bounds(ins, sw, wk)
    emit({"phase": "flagship_shape", "genome": ins.N, "rows": ins.M + 1,
          "waves": ins.waves, "band_cells": ins.band_cells,
          "planes_mb": tensor_bytes(sw.ev, sw.jd, sw.V, sw.D) / 1e6,
          "wall_s": secs, "k4_ms": ms, "k4w_ms": wms, "k4w_device_ms": wdms,
          "k4w_launch": k4w_launch(wargs, wk, wms, wdms),
          "gcups": ins.band_cells / (ms * 1e6), "k4_bound_ms": b4["bound_ms"],
          "k4w_bound_ms": b4w["bound_ms"], "k4_launch": k4_launch(ins, ms),
          "exons": exons})


def k4_same(a: SH.Sweep, b: SH.Sweep) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in SH.Sweep._fields)


def k4_err(a: SH.Sweep, b: SH.Sweep) -> float:
    """The largest difference of two sweeps' V planes and final bands."""
    return max(float((a.V - b.V).abs().max()),
               float((a.bandV - b.bandV).abs().max()))


def long_protein_paths(tmp: Path, name: str) -> list[str]:
    """The genome and protein of ``LONG_PROTEINS[name]``: lp2100 from its
    fixtures (written once from ``long_protein_gene``), the others written
    into ``tmp``."""
    if name == "lp2100":
        return [str(FIX / "long_protein_gen.fa"),
                str(FIX / "long_protein_pro.fa")]
    g, p = long_protein_gene(*LONG_PROTEINS[name])
    return [write_fasta(tmp / f"{name}_gen.fa", f"{name}_gen", g),
            write_fasta(tmp / f"{name}_pro.fa", f"{name}_pro", p)]


def phase_aln_yl2_long_protein() -> dict:
    """``aln -yl2`` with a protein past what one cluster of K4 holds
    (2,048 rows), on ``LONG_PROTEINS``, cold and warm with the plan K4's
    wrapper picks, which must be the chained variant: lp2100's output
    byte-identical to the JAX scan engine's
    (``jax_aln_yl2_long_protein.txt``); on both genes K4's planes and
    final band bit-equal to the global variant's on the same inputs, K4w's
    knots equal to the plain walk's, and (lp3500) the output the same
    bytes under the global plan.  Two copies of the planes (28 bytes a
    wave-row) sit on the card at once."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in LONG_PROTEINS:
            argv = ["-yl2", *long_protein_paths(Path(tmp), name)]
            walls = {}
            for run in ("cold", "warm"):
                calls = None
                torch.cuda.empty_cache()
                calls, text, secs = capture_aln(argv)
                walls[run] = {"seconds": secs,
                              "launches": dict(_build.LAUNCHES)}
            if name == "lp2100" and text != (
                    FIX / "jax_aln_yl2_long_protein.txt").read_text():
                raise AssertionError("aln -yl2 on lp2100 differs from "
                                     "jax_aln_yl2_long_protein.txt")
            (ins,), sw = calls["sweep"][0]
            wargs, wk = calls["walk"][0]
            del calls
            MR, npen = ins.M + 1, ins.rlmt - ins.llmt + 1
            plan = SH.launch_plan(MR, npen)
            if plan["variant"] != "chained":
                raise AssertionError(f"K4's plan on {name} is {plan}")
            if walls["warm"]["launches"].get("spliced_h_wave") != 1:
                raise AssertionError(f"aln -yl2 on {name}: {walls['warm']}")
            gplan = SH.sweep_plan(MR, npen, variant="global")
            got = []
            gms = time_once_ms(
                lambda: got.append(SH._launch_sweep(ins, gplan)))
            gsw = got.pop()
            err = k4_err(sw, gsw)
            if not k4_same(sw, gsw):
                raise AssertionError(f"K4's chained variant != its global "
                                     f"variant on {name}")
            del gsw
            if SH.walk_h_ref(*wargs) != wk:
                raise AssertionError(f"K4w knots != plain on {name}")
            b4, b4w = k4_bounds(ins, sw, wk)
            planes_mb = tensor_bytes(sw.ev, sw.jd, sw.V, sw.D) / 1e6
            del sw
            ms = time_ms(lambda: SH._launch_sweep(ins), 3)
            rec = {"genome": ins.N, "rows": MR, "waves": ins.waves,
                   "band_cells": ins.band_cells, "planes_mb": planes_mb,
                   "walls": walls, "knots": len(wk.knots),
                   "global_equal": True, "max_abs_err": err,
                   "knots_equal": True,
                   "k4_ms": ms, "k4_us_per_wave": ms * 1e3 / ins.waves,
                   "gcups": ins.band_cells / (ms * 1e6),
                   "k4_global_ms": gms,
                   "k4_global_us_per_wave": gms * 1e3 / ins.waves,
                   "k4_bound": b4, "k4w_bound_ms": b4w["bound_ms"],
                   "k4_launch": k4_launch(ins, ms),
                   "clusters_held": SH.clusters_held(plan, npen),
                   "global_launch": {**gplan, **SH.spliced_h_wave_attrs(
                       "global")}}
            if name != "lp2100":
                real = SH.launch_plan
                SH.launch_plan = lambda MR_, npen_: SH.sweep_plan(
                    MR_, npen_, variant="global")
                try:
                    gcalls, gtext, gsecs = capture_aln(argv)
                finally:
                    SH.launch_plan = real
                del gcalls
                if gtext != text:
                    raise AssertionError(f"aln -yl2 on {name} differs under "
                                         "the global plan")
                rec["global_plan_wall_s"] = gsecs
                rec["output_equal"] = True
            else:
                rec["fixture_equal"] = True
            emit({"phase": f"aln_yl2_long_protein_{name}", **rec})
            out[name] = rec
    print(card_line(), flush=True)
    return out


def mutate(rng, base, sub=0.03, indels=2):
    """tests/test_seeded.py's mutant: substitutions and short indels."""
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


def chunk_cells(ins: dict, d0: int, n: int) -> int:
    """Band cells K2 computes in steps d0 to d0 + n - 1 (pair 0)."""
    la, lb, lw, up = (int(ins[k][0]) for k in ("la", "lb", "lw", "up"))
    d = np.arange(max(d0, 1), d0 + n)[:, None]
    r = np.arange(lw, up + 1)[None, :]
    m = (d - r) // 2
    ok = ((d - r) % 2 == 0) & (m >= 0) & (m <= la) & (d - m >= 0) & (
        d - m <= lb)
    return int(ok.sum())


def k2_chunk_bound(ins: dict, d0: int, n: int, nslot: int) -> dict:
    """K2's bound on a chunk: its inputs and carries read and written
    once, its planes written once; per cell the profile product and six
    crg sums over the real member pairs (f64) and the lane update."""
    plan = G.wavefront_plan(ins, nslot=nslot)
    C = ins["CA"].shape[2]
    cells = chunk_cells(ins, d0, n)
    rows = 5 * plan["an_max"] + 5 * plan["bn_max"]
    carry = 2 * nslot * 21 + 2 * 4 * rows * (nslot + 2)
    nbytes = tensor_bytes(*ins.values()) + carry + 2 * n * nslot + 4
    return bound(nbytes, 9 * cells,
                 cells * (2 * C + 12 * plan["real_pairs"][0]))


def range_starts(ins: dict, d0: int, n: int):
    """Starts of the range walk on a chunk's top row: the cell on the end
    diagonal lb - la where the band holds it (pair 0), lane 0."""
    la, lb = int(ins["la"][0]), int(ins["lb"][0])
    top = d0 + n - 1
    m0 = max(min((top - (lb - la)) // 2, la), 0)
    return m0, top - m0


def chunk_check(name: str, ins: dict, nslot: int, ls3: bool,
                variant, starts) -> dict:
    """K2 from its own carry at each start against the plain version
    from the same carry (planes, score, output carry), and K3's range
    walk in both variants on each chunk's planes; returns the timings of
    the last chunk."""
    dev = ins["CA"].device
    carry, at, out = None, 0, {}
    kw = dict(nslot=nslot, ls3=ls3, variant=variant)
    for d0 in starts:
        if d0 > at:
            carry = G.group_wavefront(ins, nsteps=d0 - at, d0=at,
                                      carry=carry, **kw)[3]
            at = d0
        got = G.group_wavefront(ins, nsteps=256, d0=d0, carry=carry, **kw)
        ref = []
        plain_ms = time_once_ms(lambda: ref.append(G.group_wavefront_ref(
            ins, nslot=nslot, ls3=ls3, nsteps=256, d0=d0, carry=carry)))
        ref = ref[0]
        if not (torch.equal(got[0].view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
                and G.carry_equal(got[3], ref[3])):
            raise AssertionError(f"K2 != plain on {name} at step {d0}")
        m0, n0 = range_starts(ins, d0, 256)
        wargs = [torch.tensor([x], dtype=torch.int32, device=dev)
                 for x in (m0, n0, 0, d0)] + [ins["lw"]]
        want = G.traceback_range_ref(got[1], got[2], *wargs, max_iters=520)
        for k3 in ("staged", "global"):
            plan = G.traceback_plan(256, nslot, 520, variant=k3)
            walk = G.traceback_range(got[1], got[2], *wargs, max_iters=520,
                                     plan=plan)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(walk, want)):
                raise AssertionError(f"K3 range walk ({k3}) != plain on "
                                     f"{name} at step {d0}")
        out = {"d0": d0, "steps": 256, "ms": time_ms(
            lambda: G.group_wavefront(ins, nsteps=256, d0=d0, carry=carry,
                                      **kw), 3),
            "plain_ms": plain_ms, **k2_chunk_bound(ins, d0, 256, nslot)}
    plan = G.wavefront_plan(ins, nslot=nslot, ls3=ls3, variant=variant)
    emit({"phase": f"long_pair_chunks_{name}", "starts": list(starts),
          "nslot": nslot, "variant": plan["variant"], "ls3": ls3,
          "planes_equal": True, "scores_equal": True, "carries_equal": True,
          "range_walks_equal": True, "last_chunk": out,
          **G.group_wavefront_attrs(ls3, plan["variant"])})
    return out


@contextlib.contextmanager
def long_probe(k2_d0=None):
    """CUDA events around K2's and K3's range walk calls, with the
    arguments of the first K2 call at step ``k2_d0`` and those of the
    first range walk there but its planes (none is kept, so the probe
    leaves the peak memory as it was); each K2 call's pairs, slots and
    steps."""
    rec = {"events": collections.defaultdict(list), "walk": None,
           "k2": None, "k2_calls": []}

    def evented(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec["events"][name].append((start, end))
            if name == "group_wavefront":
                ins = args[0]
                rec["k2_calls"].append((ins["CA"].shape[0], kwargs["nslot"],
                                        kwargs["nsteps"]))
                if rec["k2"] is None and kwargs.get("d0") == k2_d0:
                    rec["k2"] = (ins, kwargs)
            elif rec["walk"] is None and int(args[5][0]) == k2_d0:
                rec["walk"] = (args[2:], kwargs, out)
            return out
        return call

    saved = (G.group_wavefront, G.traceback_range)
    G.group_wavefront = evented("group_wavefront", saved[0])
    G.traceback_range = evented("traceback_range", saved[1])
    try:
        yield rec
    finally:
        G.group_wavefront, G.traceback_range = saved


def measured(fn):
    """One run on the card: its result, wall seconds, launches and peak
    device memory (bytes allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, dict(_build.LAUNCHES),
            torch.cuda.max_memory_allocated())


def phase_long_pair(dev) -> dict:
    """Phase 12; returns the kernels line's K2 sub-entry and the range
    walk's entry."""
    dna, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))

    def dna_msa(arr):
        m = Msa(codes=ab.encode("".join("ACGT"[c] for c in arr),
                                ab.DNA)[None, :], molc=ab.DNA, names=["g"])
        m.prepare(dna.shape[0])
        return m

    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, LONG_PAIR["dna_nt"])
    A, B = dna_msa(base), dna_msa(mutate(rng, base))
    La, Lb = A.length, B.length
    w = stripe(La, Lb, -60)
    nslot = G._bucket(w.up - w.lw + 3, 128)
    ins = G.stack_inputs([G._pack_inputs(
        A, B, dna, 2.0, 9.0, w, 1, 1, G._bucket(La), G._bucket(Lb),
        uniform=False)], dev)
    if G.wavefront_plan(ins, nslot=nslot)["variant"] != "wide":
        raise AssertionError("the 20 kb pair did not take K2's wide variant")
    # (a) carried chunks, kernel against plain version
    wide_chunk = chunk_check("dna20k", ins, nslot, False, None,
                             LONG_PAIR["dna_starts"])
    prot, _ = scoring.protein_matrix(AlnParams(pam=150))
    prng = np.random.default_rng(1)

    def prot_msa(many, L):
        codes = (prng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
        codes[prng.random((many, L)) < 0.08] = ab.GAP
        codes[:, 0] = ab.ALA + prng.integers(0, 20)
        m = Msa(codes=codes, molc=ab.PROTEIN,
                names=[f"s{i}" for i in range(many)],
                weight=prng.random(many) + 0.5)
        m.prepare(prot.shape[0])
        return m

    PA, PB = (prot_msa(3, L) for L in LONG_PAIR["prot"])
    pw = stripe(PA.length, PB.length, -60)
    pslot = G._bucket(pw.up - pw.lw + 3, 128)
    for ls in (1, 3):
        pins = G.stack_inputs([G._pack_inputs(
            PA, PB, prot, 2.0, 9.0, pw, 3, 3, G._bucket(PA.length),
            G._bucket(PB.length), spb=20.0, ls=ls, uniform=False)], dev)
        for variant in ("shared", "global"):
            chunk_check(f"prot1000_ls{ls}_{variant}", pins, pslot, ls == 3,
                        variant, LONG_PAIR["prot_starts"])
        del pins

    # (b) the standard and the linear-space aligner on the pair
    chunk = LONG_PAIR["chunk"]
    # the forward pass's middle chunk, timed at the end
    mid = (G._bucket(La + Lb + 1, G.K2_DSTEP) // chunk) // 2 * chunk
    with long_probe() as probe:
        (std, std_wall, std_launch, std_peak) = measured(
            lambda: G.group_align(A, B, dna, 2.0, 9.0, device=dev))
        std_k2 = sum(a.elapsed_time(b)
                     for a, b in probe["events"]["group_wavefront"])
    with long_probe(mid) as probe:
        (lin, lin_wall, lin_launch, lin_peak) = measured(
            lambda: G.group_align_linear(A, B, dna, 2.0, 9.0, chunk=chunk,
                                         device=dev))
        lin_k2 = sum(a.elapsed_time(b)
                     for a, b in probe["events"]["group_wavefront"])
        lin_walk = sum(a.elapsed_time(b)
                       for a, b in probe["events"]["traceback_range"])
        k2_calls = len(probe["events"]["group_wavefront"])
    for k in ("group_wavefront", "traceback_range"):
        if lin_launch.get(k, 0) <= 0:
            raise AssertionError(f"the linear aligner never launched {k}")
    if np.float32(std[0]).view(np.int32) != np.float32(lin[0]).view(np.int32):
        raise AssertionError(f"linear score {lin[0]} != standard {std[0]}")
    if std[1] != lin[1]:
        raise AssertionError("linear SKL != standard SKL on the 20 kb pair")
    if not 5 * lin_peak < std_peak:
        raise AssertionError(f"linear peak {lin_peak} bytes is not under a "
                             f"fifth of the standard's {std_peak}")
    std_steps = G._bucket(La + Lb + 1)
    lin_steps = k2_calls * chunk
    regs = G.group_wavefront_attrs(False, "wide")
    emit({"phase": "long_pair_align", "la": La, "lb": Lb, "nslot": nslot,
          "score": std[0], "scores_equal": True, "skls_equal": True,
          "skl_vertices": len(std[1]), "k2_variant": "wide", **regs,
          "standard": {"wall_s": std_wall, "peak_bytes": std_peak,
                       "launches": std_launch, "k2_ms": std_k2,
                       "steps": std_steps,
                       "us_per_step": std_k2 * 1e3 / std_steps},
          "linear": {"wall_s": lin_wall, "peak_bytes": lin_peak,
                     "launches": lin_launch, "k2_ms": lin_k2,
                     "k2_calls": k2_calls, "steps": lin_steps,
                     "us_per_step": lin_k2 * 1e3 / lin_steps,
                     "range_walk_ms": lin_walk},
          "peak_ratio": lin_peak / std_peak})

    # K2 and the range walk at the linear aligner's shapes: its forward
    # pass's middle chunk, and the walk of that chunk's recomputed planes
    k2ins, k2kw = probe["k2"]
    planes = G.group_wavefront(k2ins, **k2kw)[1:3]
    starts, kwargs, (m, n, lane, moves, cnt) = probe["walk"]
    args = (*planes, *starts)
    want = G.traceback_range_ref(*args, **kwargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            (m, n, lane, moves, cnt), want)):
        raise AssertionError("K3 range walk != plain on the linear run")
    walk = {"max_abs_err": 0.0,
            "ms": time_ms(lambda: G.traceback_range(*args, **kwargs), 7),
            "device_ms": queued_ms(lambda: G.traceback_range(*args, **kwargs),
                                   20),
            "plain_ms": time_ms(lambda: G.traceback_range_ref(*args,
                                                              **kwargs), 3),
            # a move reads one dirs and one opens byte and writes one move
            **bound(3 * int(cnt.sum()) + 4 * 9, 0),
            "moves": int(cnt.sum()), "nslot": args[0].shape[2],
            "chunk_steps": args[0].shape[1],
            "variant": G.traceback_plan(args[0].shape[1], args[0].shape[2],
                                        kwargs["max_iters"])["variant"]}
    del probe, args, planes, moves
    chunk_ms = time_ms(lambda: G.group_wavefront(k2ins, **k2kw), 3)

    # (c) the seeded aligner against the standard result
    a_codes, b_codes = (x.codes[0].astype(np.int64) for x in (A, B))
    anchors = [h for h in seeded.chain_hsps(seeded.find_hsps(a_codes,
                                                             b_codes, k=12))
               if h.length >= 32 + 2 * 12]
    with long_probe() as sprobe:
        (sd, sd_wall, sd_launch, sd_peak) = measured(
            lambda: seeded.seeded_align(A, B, dna, 2.0, 9.0, device=dev))
        batches = list(sprobe["k2_calls"])
    for k in ("group_wavefront", "traceback"):
        if sd_launch.get(k, 0) <= 0:
            raise AssertionError(f"the seeded aligner never launched {k}")
    if abs(sd[0] - std[0]) > max(1e-2, 1e-5 * abs(std[0])):
        raise AssertionError(f"seeded score {sd[0]} != standard {std[0]}")
    if sd[1] != std[1]:
        raise AssertionError("seeded SKL != standard SKL on the 20 kb pair")
    emit({"phase": "long_pair_seeded", "score": sd[0],
          "standard_score": std[0], "skls_equal": True,
          "anchors": len(anchors),
          "anchored_nt": sum(h.length - 24 for h in anchors),
          "sub_dp_batches": [{"pairs": b, "nslot": s, "nsteps": t}
                             for b, s, t in batches],
          "wall_s": sd_wall, "peak_bytes": sd_peak, "launches": sd_launch})
    k2_long = {"launches": lin_launch["group_wavefront"], "variant": "wide",
               "chunk_ms": chunk_ms, "chunk_steps": chunk, "chunk_d0": mid,
               "us_per_step": chunk_ms * 1e3 / chunk, **wide_chunk,
               "max_abs_err": 0.0, "standard_k2_ms": std_k2,
               "linear_k2_ms": lin_k2}
    walk_entry = {"name": "traceback_range", "route": "cuda",
                  "source": "prrn_aln_tpu_torch/csrc/traceback.cu",
                  "replaces": "prrn_aln_tpu/ops/group.py:678",
                  "launches": lin_launch["traceback_range"], **walk}
    return k2_long, walk_entry


GROUPS = "1 2/3-5/6"


def write_cli_inputs(tmp: Path) -> dict:
    """Phase 13's pre-aligned inputs: Multi_A and Multi_B rebuilt from
    the galign fixture (as tests/test_update.py builds them) and ce13a17
    aligned, from the rows of ``jax_prrn_ce13a17_clean_R0.txt``."""
    gfix = json.loads((FIX / "galign_fixtures.json").read_text())
    multi = []
    for key in ("pas/Multi_A", "pas/Multi_B"):
        info = gfix["files"][key]
        p = tmp / key.split("/")[-1]
        with open(p, "w") as f:
            f.write(f"{len(info['rows']):5d}{len(info['rows'][0]):6d}\tx\n")
            for n, r in zip(info["names"], info["rows"]):
                f.write(f">{n}\n{r}\n/\n")
        multi.append(str(p))
    ce = tmp / "ce13a17_aligned.fa"
    ce.write_text("".join(
        f">{r.name}\n{r.seq}\n"
        for r in pio.sniff_and_read(FIX / "jax_prrn_ce13a17_clean_R0.txt")))
    return {"multi": multi, "ce13a17": str(ce)}


# the refgs family's exon structure of ce13a1 in its genome, and the
# perturbed one (a wrong second-exon start)
REFGS_EXONS = [(66, 251), (307, 651)]
REFGS_BAD = [(66, 251), (331, 651)]


def refgs_family_inputs() -> tuple[str, list]:
    """The refgs family from files in the repository (as
    tests/test_refgs.py builds it from the reference's samples): the
    genome is CET10B9[31549:32450] (``cet10b9_win31401.fa[149:1050]``),
    ce13a1 its translated two-exon structure, the other members the
    first 172 residues of ``ce13a17_clean.fa``'s.  Returns the genome and
    (name, protein, exons or None) for each member."""
    from prrn_aln_tpu_torch.utils.seqtools import translate
    g = pio.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()
    g = g[149:1050]
    cds = "".join(g[a - 1:b] for a, b in REFGS_EXONS)
    members = [("ce13a1", translate(ab.encode(cds, ab.DNA)),
                list(REFGS_EXONS))]
    members += [(r.name, r.seq[:172], None)
                for r in pio.read_fasta(FIX / "ce13a17_clean.fa")
                if r.name != "ce13a1"]
    return g, members


def refgs_text(res) -> str:
    """A refgs result as its fixture holds it: iterations, each member's
    status, ;C exons and sequence, the outliers and the rebuilt MSA's
    rows."""
    lines = [f"iters {res.iters}"]
    for r in res.records:
        lines.append(f">{r.name}\t{res.status[r.name]}")
        if r.exons:
            lines.append(";C join(" + ",".join(
                f"{a}..{b}" for a, b in r.exons) + ")")
        lines.append(r.seq)
    lines.append("outliers " + " ".join(res.outliers))
    lines.append(f"msa_rows {res.msa.many if res.msa is not None else 0}")
    return "\n".join(lines) + "\n"


def write_refgs_inputs(tmp: Path, g: str, members) -> tuple[str, str]:
    """The family ((name, protein, exons) each) and its genome as files
    for ``refgs_main``."""
    fam = tmp / "refgs_family.fa"
    lines = []
    for name, seq, exons in members:
        lines.append(f">{name}")
        if exons:
            lines.append(";C join(" + ",".join(
                f"{a}..{b}" for a, b in exons) + ")")
        lines.append(seq)
    fam.write_text("\n".join(lines) + "\n")
    gen = tmp / "refgs_genome.fa"
    gen.write_text(">win\n" + g + "\n")
    return str(fam), str(gen)


def run_cli(main, argv, env=None) -> tuple[str, float, dict]:
    """One CLI run on the card with the launch counts set to 0 just
    before it: its standard output, seconds and launches."""
    buf = io.StringIO()
    for k, x in (env or {}).items():
        os.environ[k] = x
    try:
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
    finally:
        for k in env or {}:
            os.environ.pop(k, None)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}")
    return buf.getvalue(), secs, counts


def ls3_pair(multi) -> tuple[str, float, dict]:
    """``align_pair(ls=3)`` on Multi_A x Multi_B on the card (K2's
    long-gap lanes, then K3): the score, swap, SKL and merged rows, in
    the layout of ``jax_align_pair_ls3_multiAB.txt``."""
    A, B = (pio.records_to_msa(pio.sniff_and_read(p), ab.PROTEIN)
            for p in multi)
    params = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, skl, swapped = progressive.align_pair(
        A, B, mtx, u=params.u, v=params.v, sh=params.sh, ls=3,
        device=torch.device("cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    if swapped:
        A, B = B, A
    text = (f"score {score!r}\nswapped {swapped}\n"
            f"skl {json.dumps([list(map(int, k)) for k in skl])}\n"
            + pio.write_native_block(merge_msas(A, B, skl)))
    return text, secs, counts


def phase_cli_modes() -> dict:
    """Phase 13: the ``prrn`` and ``aln`` modes of this slice on the card,
    each against the JAX package's output fixture (and the reference's
    golden rows where there is one), each with the kernels it must
    launch.  Returns each mode's launches."""
    need = {"prrn_U_R0": ("group_wavefront", "traceback"),
            "prrn_guided5_R0": ("group_wavefront", "traceback"),
            "prrn_G_ce13a17": ("group_wavefront", "traceback"),
            "prrn_resume_ce13a17": ("group_wavefront", "traceback"),
            "prrn_e_fam19_I0": ("pairwise", "group_wavefront", "traceback"),
            "prrn_e_fam19_I0_fused": ("pairwise_rows", "group_wavefront",
                                      "traceback"),
            "aln_multiAB": (),
            "align_pair_ls3": ("group_wavefront", "traceback"),
            "aln_R10": ("pairwise",)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        ins = write_cli_inputs(tmp)
        multi = ins["multi"]

        def check(mode, text, secs, counts, fixture, golden=None):
            if text != (FIX / fixture).read_text():
                raise AssertionError(f"{mode}: output differs from {fixture}")
            exact = None
            if golden:
                want = golden_rows((FIX / golden).read_text())
                got = golden_rows(text)
                exact = sum(got.get(k) == v for k, v in want.items())
                if exact != len(want) or set(got) != set(want):
                    raise AssertionError(f"{mode}: {exact}/{len(want)} "
                                         f"rows of {golden}")
            for k in need[mode]:
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"{mode} never launched {k}")
            out[mode] = counts
            emit({"phase": f"cli_{mode}", "seconds": secs,
                  "bytes": len(text), "fixture": fixture,
                  "golden_rows_exact": exact, "launches": counts})

        check("prrn_U_R0", *run_cli(prrn_main, ["-U", "-R", "0", *multi]),
              "jax_prrn_U_R0_multiAB.txt", "golden_prrn_U_R0.txt")
        here = os.getcwd()
        os.chdir(FIX)                # the tree's leaves are relative paths
        try:
            res = run_cli(prrn_main, ["-b", "guide5.nwk", "-R", "0"])
        finally:
            os.chdir(here)
        check("prrn_guided5_R0", *res, "jax_prrn_guided5_R0.txt",
              "golden_prrn_guided5.txt")
        check("prrn_G_ce13a17",
              *run_cli(prrn_main, ["-R", "0", "-G", GROUPS, ins["ce13a17"]]),
              "jax_prrn_G_ce13a17.txt")
        check("prrn_resume_ce13a17",
              *run_cli(prrn_main, ["--resume",
                                   str(FIX / "jax_ckpt_ce13a17_I0.npz")]),
              "jax_prrn_resume_ce13a17.txt")
        for mode, env in (("prrn_e_fam19_I0", None),
                          ("prrn_e_fam19_I0_fused", {"PRRN_PW_FUSED": "1"})):
            prefix = tmp / mode
            res = run_cli(prrn_main, ["-R", "0", "-I", "0", "-e", str(prefix),
                                      str(FIX / "fam19.fa")], env=env)
            k = 0
            while (tmp / f"{mode}.{k}").exists():
                fix = f"jax_prrn_fam19_e_I0.{k}.txt"
                if (tmp / f"{mode}.{k}").read_text() != (FIX / fix) \
                        .read_text():
                    raise AssertionError(f"{mode}: {prefix.name}.{k} differs "
                                         f"from {fix}")
                k += 1
            if k != 7 or (FIX / f"jax_prrn_fam19_e_I0.{k}.txt").exists():
                raise AssertionError(f"{mode}: {k} sub-MSAs written")
            if env and res[2].get("pairwise", 0) != 0:
                raise AssertionError("K1 was launched under PRRN_PW_FUSED=1")
            check(mode, *res, "jax_prrn_fam19_e_I0.0.txt")
        check("aln_multiAB", *run_cli(aln_main, multi),
              "golden_aln_multiAB.txt")
        check("align_pair_ls3", *ls3_pair(multi),
              "jax_align_pair_ls3_multiAB.txt")
        check("aln_R10", *run_cli(aln_main, ["-R", "10", str(FIX / "idn_p.fa"),
                                             str(FIX / "idn_q.fa")]),
              "jax_aln_R10_idn.txt")
    if out["aln_R10"].get("pairwise") != 1:
        raise AssertionError("aln -R 10 made more than one K1 launch")
    print(card_line(), flush=True)
    return out


# aln -G's modes (the fixtures' suffix and the flags), and the genes of
# phase 14 made from a seed: (nexon, exon nt, intron nt, flank nt, share
# of the cDNA substituted)
ALN_G_MODES = {"O0": ["-O", "0"], "O2": ["-O", "2"], "O3": ["-O", "3"],
               "O4": ["-O", "4"], "O5": ["-O", "5"], "default": []}
GENES = {"medium": (1, 3, (180, 220), (900, 1100), 300, 0.01),
         "realistic": (0, 8, (150, 401), (300, 4001), 1000, 0.01),
         "long": (2, 12, (400, 601), (300, 3001), 1000, 0.01)}
# phase 14's forced plans of K5's chained variant on the medium gene
K5_CHAINED = {"clusters5": dict(ctas=2, clusters=5),
              "passes2": dict(ctas=2, clusters=5, per_pass=2)}


# fwd2h's long-intron gene: introns of lengths at which a penalty tail
# taken with a correctly rounded log differs from the scan engine's
# compiled one in the last bit
LONG_INTRONS = (879, 1187)

_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_CODONS = {}
for _k, _aa in enumerate(_CODE):
    _CODONS.setdefault(_aa, []).append(
        "TCAG"[_k // 16] + "TCAG"[_k // 4 % 4] + "TCAG"[_k % 4])


def long_intron_gene(seed: int = 0) -> tuple[str, str]:
    """A seeded gene (genome, protein): 180 random residues back-
    translated into three exons joined by GT...AG introns of
    LONG_INTRONS nt, in 300-nt random flanks (about 3.2 kb)."""
    rng = np.random.default_rng(seed)
    aas = sorted(a for a in _CODONS if a != "*")
    prot = "".join(aas[k] for k in rng.integers(0, len(aas), 180))
    cds = "".join(_CODONS[a][rng.integers(0, len(_CODONS[a]))]
                  for a in prot)

    def rand(k):
        return "".join("ACGT"[x] for x in rng.integers(0, 4, k))

    cut = (181, 362)
    exons = (cds[:cut[0]], cds[cut[0]:cut[1]], cds[cut[1]:])
    introns = ["GTAAGT" + rand(n - 12) + "TTTCAG" for n in LONG_INTRONS]
    genome = (rand(300) + exons[0] + introns[0] + exons[1] + introns[1]
              + exons[2] + rand(300))
    return genome, prot


# fwd2h past what one cluster of K4 holds (2,048 rows): seed, residues,
# exons, intron lengths (half-open) and flank of ``long_protein_gene``.
# lp2100 (~8 kb, ~14,300 waves) is held byte for byte to the JAX scan
# engine's output; lp3500 (~37 kb, ~47,500 waves) is a large gene of a
# proteome (a twitchin- or BRCA2-sized protein) for the timing
LONG_PROTEINS = {"lp2100": (21, 2100, 10, (60, 301), 200),
                 "lp3500": (35, 3500, 25, (60, 2001), 1000)}


def long_protein_gene(seed: int, residues: int, nexon: int,
                      intron: tuple, flank: int) -> tuple[str, str]:
    """A seeded gene (genome, protein): ``residues`` random residues
    back-translated into ``nexon`` exons of about equal length joined by
    GTAAGT...TTTCAG introns of lengths drawn from ``intron``, in random
    flanks of ``flank`` nt."""
    rng = np.random.default_rng(seed)
    aas = sorted(a for a in _CODONS if a != "*")
    prot = "".join(aas[k] for k in rng.integers(0, len(aas), residues))
    cds = "".join(_CODONS[a][rng.integers(0, len(_CODONS[a]))]
                  for a in prot)

    def rand(k):
        return "".join("ACGT"[x] for x in rng.integers(0, 4, k))

    step = len(cds) // nexon
    cuts = [0] + [k * step + int(rng.integers(-step // 4, step // 4 + 1))
                  for k in range(1, nexon)] + [len(cds)]
    parts = [rand(flank)]
    for k in range(nexon):
        parts.append(cds[cuts[k]:cuts[k + 1]])
        if k < nexon - 1:
            n = int(rng.integers(*intron))
            parts.append("GTAAGT" + rand(n - 12) + "TTTCAG")
    parts.append(rand(flank))
    return "".join(parts), prot


def spliced_gene(name: str) -> tuple[str, str, list]:
    """A gene of ``GENES`` from its seed: random exons joined by GT...AG
    introns in random flanks, its cDNA (the joined exons with a share of
    point substitutions) and its introns' lengths."""
    seed, nexon, exon, intron, flank, sub = GENES[name]
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))

    def rand(k):
        return "".join(bases[rng.integers(0, 4, k)])

    exons = [rand(int(rng.integers(*exon))) for _ in range(nexon)]
    parts = [rand(flank)]
    introns = []
    for k, ex in enumerate(exons):
        parts.append(ex)
        if k < nexon - 1:
            introns.append(int(rng.integers(*intron)))
            parts.append("GT" + rand(introns[-1] - 4) + "AG")
    parts.append(rand(flank))
    cdna = np.array(list("".join(exons)))
    pos = rng.choice(len(cdna), int(round(sub * len(cdna))), replace=False)
    for p_ in pos:
        cdna[p_] = bases[(int(np.nonzero(bases == cdna[p_])[0][0])
                          + int(rng.integers(1, 4))) % 4]
    return "".join(parts), "".join(cdna), introns


def capture_aln_G(argv) -> tuple[dict, str, float, dict]:
    """One ``aln -G`` run on the card with recorders at K5's launch and
    the host traceback; returns K5's calls as (inputs, output), the host
    traceback's seconds, the output, the run's seconds and launches."""
    calls = {"sweep": [], "traceback_s": 0.0}
    real_s, real_t = SS._launch_sweep_s, SS._traceback

    def rec_s(ins, plan=None):
        out = real_s(ins, plan)
        calls["sweep"].append((ins, out))
        return out

    def rec_t(*args):
        t0 = time.perf_counter()
        out = real_t(*args)
        calls["traceback_s"] += time.perf_counter() - t0
        return out

    SS._launch_sweep_s, SS._traceback = rec_s, rec_t
    try:
        text, secs, counts = run_cli(aln_main, argv)
    finally:
        SS._launch_sweep_s, SS._traceback = real_s, real_t
    return calls, text, secs, counts


def k5_check(name: str, ins: SS.SweepInputsS, sws: list,
             on_card: bool) -> dict:
    """K5's planes and final H band (of each output in ``sws``) against
    the plain version's, bit for bit (the values as their bits), and the
    score and knots that lastS and the traceback make of each.  The plain
    version runs on the card (timed there) or on a CPU copy of the same
    inputs (the penalty table is one of them, so the copy computes the
    same values)."""
    if on_card:
        got = []
        plain_ms = time_once_ms(lambda: got.append(SS.sweep_s_ref(ins)))
        ref, out = got[0], {"plain_ms": plain_ms}
    else:
        t0 = time.perf_counter()
        ref = SS.sweep_s_ref(ins.to("cpu"))
        out = {"plain_ms": None,
               "plain_cpu_ms": (time.perf_counter() - t0) * 1e3}
    want_knots = SS.finish_s(ins, ref)
    for k, sw in enumerate(sws):
        for field in SS.SweepS._fields:
            got, want = getattr(sw, field).cpu(), getattr(ref, field).cpu()
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError(f"K5 output {k}'s {field} != plain on "
                                     f"{name}")
        score, skl = SS.finish_s(ins, sw)
        if (score, skl) != want_knots:
            raise AssertionError(f"K5 output {k}'s knots != plain on {name}")
    sw = sws[0]
    out["max_abs_err"] = float((sw.HV.cpu() - ref.HV.cpu()).abs().max())
    out["knots"] = len(skl)
    return out


def k5_ops(ins: SS.SweepInputsS) -> int:
    """Float operations the sweep needs on these inputs (counted from
    sweep_s_ref's wave body): 12 a band cell (the diagonal, vertical and
    horizontal candidates and their maxima), at most 16 more at an
    acceptor site (4 candidates of 3 adds and a compare) and 21 at a
    donor site (3 lanes of threshold, value and rank compares)."""
    la, lb = ins.la, ins.lb
    cano3 = ins.cano3.cpu().numpy() > 0
    cano5 = ins.cano5.cpu().numpy() > 0
    acc = np.concatenate([[0], np.cumsum(cano3)])
    don = np.concatenate([[0], np.cumsum(cano5)])
    m = np.arange(ins.m_start, la + 1)
    lo = np.maximum(m + ins.lw, 1)
    hi = np.minimum(m + ins.up, lb)
    ok = hi >= lo
    cells = int(np.where(ok, hi - lo + 1, 0).sum())
    sites = ok & ((m < la) | (not ins.a_exgr))
    lo_c, hi_c = np.clip(lo, 0, lb + 1), np.clip(hi + 1, 0, lb + 1)
    n_acc = int(np.where(sites, acc[hi_c] - acc[lo_c], 0).sum())
    n_don = int(np.where(sites, don[hi_c] - don[lo_c], 0).sum())
    return 12 * cells + 16 * n_acc + 21 * n_don


def k5_bound(ins: SS.SweepInputsS, sw: SS.SweepS) -> dict:
    ins_bytes = tensor_bytes(*(v for v in vars(ins).values()
                               if isinstance(v, torch.Tensor)))
    return bound(ins_bytes + tensor_bytes(*sw), k5_ops(ins))


def k5_plans(ins: SS.SweepInputsS) -> tuple[dict, dict]:
    """The plan K5's wrapper picks for these inputs, and the global
    variant's."""
    K, npen = ins.mtx.shape[0], ins.lb + 2
    return (SS.launch_plan(ins.rows, K, npen),
            SS.sweep_s_plan(ins.rows, K, npen, variant="global"))


def k5_launch(plan: dict, ins: SS.SweepInputsS, ms: float) -> dict:
    """A K5 plan (variant, clusters, CTAs a cluster, rows a CTA, threads,
    rows a thread, clusters a launch, launches, what sits in shared
    memory), microseconds a wave, and the kernel's registers and spilled
    bytes."""
    return {"variant": plan["variant"], "clusters": plan["clusters"],
            "ctas": plan["ctas"], "per_pass": plan["per_pass"],
            "passes": plan["passes"],
            "rows_a_cta": plan["rows"], "threads": plan["threads"],
            "rows_a_thread": plan["rpt"],
            "rings_in_smem": plan["ring_smem"],
            "penalty_in_smem": plan["pen_smem"], "smem_bytes": plan["smem"],
            "ms": ms, "us_per_wave": ms * 1e3 / max(ins.waves, 1),
            **SS.spliced_s_wave_attrs(plan["variant"], plan["rpt"] > 1)}


def k5_same(a: SS.SweepS, b: SS.SweepS) -> bool:
    """Two sweeps' planes and final H band equal, bit for bit."""
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def phase_aln_G_long(paths: tuple, introns: list) -> dict:
    """Phase 14 (d): ``aln -G -O 4`` on the long gene (a cDNA past what one
    cluster holds) cold and warm with the plan K5's wrapper picks, which
    must chain two or more clusters; its planes, final band, score and
    knots bit-equal to the global variant's, and its output equal to the
    run under the global plan.  The planes (16 bytes a cell) sit on the
    card one copy at a time: the chained variant's go to the host before
    the global variant runs."""
    walls = {}
    calls = None
    for run in ("cold", "warm"):
        calls = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls, text, secs, counts = capture_aln_G(["-G", "-O", "4", *paths])
        walls[run] = {"seconds": secs, "launches": counts,
                      "traceback_s": calls["traceback_s"],
                      "peak_mb": torch.cuda.max_memory_allocated() / 1e6}
    (ins, sw), = calls["sweep"]
    del calls
    plan, gplan = k5_plans(ins)
    if plan["variant"] != "chained" or plan["clusters"] < 2:
        raise AssertionError(f"K5's plan on the long gene is {plan}")
    if walls["warm"]["launches"].get("spliced_s_wave") != plan["passes"]:
        raise AssertionError(f"aln -G on the long gene: {walls['warm']}")
    bnd = k5_bound(ins, sw)
    planes_mb = tensor_bytes(sw.ev, sw.jdon) / 1e6
    host = SS.SweepS(*(x.cpu() for x in sw))
    del sw
    ms = time_ms(lambda: SS._launch_sweep_s(ins), 5)
    gsw = SS._launch_sweep_s(ins, gplan)
    if not k5_same(host, SS.SweepS(*(x.cpu() for x in gsw))):
        raise AssertionError("K5's chained variant != its global variant on "
                             "the long gene")
    knots = SS.finish_s(ins, gsw)
    del gsw
    if SS.finish_s(ins, host) != knots:
        raise AssertionError("K5's chained variant's score or knots != the "
                             "global variant's on the long gene")
    del host
    gms = time_ms(lambda: SS._launch_sweep_s(ins, gplan), 3)
    real = SS.launch_plan
    SS.launch_plan = lambda rows, K, npen: SS.sweep_s_plan(
        rows, K, npen, variant="global")
    try:
        gcalls, gtext, gsecs, gcounts = capture_aln_G(["-G", "-O", "4",
                                                       *paths])
    finally:
        SS.launch_plan = real
    del gcalls
    if gtext != text:
        raise AssertionError("aln -G on the long gene differs under the "
                             "global plan")
    rec = {"phase": "aln_G_long", "rows": ins.rows, "W": ins.W,
           "genome": ins.lb, "waves": ins.waves,
           "band_cells": ins.band_cells, "planes_mb": planes_mb,
           "introns": introns, "output_lines": len(text.splitlines()),
           "output_bytes": len(text), "walls": walls,
           "global_plan_wall": {"seconds": gsecs, "launches": gcounts},
           "global_equal": True, "knots": len(knots[1]),
           "output_equal": True, "k5_ms": ms,
           "k5_us_per_wave": ms * 1e3 / ins.waves,
           "gcups": ins.band_cells / (ms * 1e6), "k5_bound": bnd,
           "k5_launch": k5_launch(plan, ins, ms),
           "k5_global": k5_launch(gplan, ins, gms)}
    emit(rec)
    return {"ms": ms, "us_per_wave": ms * 1e3 / ins.waves, "global_ms": gms,
            "global_us_per_wave": gms * 1e3 / ins.waves, **bnd,
            "waves": ins.waves, "rows": ins.rows,
            "launches": walls["warm"]["launches"]["spliced_s_wave"],
            "plan": {k: plan[k] for k in ("variant", "clusters", "ctas",
                                          "rows", "passes")}}


def phase_aln_G() -> dict:
    """Phase 14: ``aln -G`` (a cDNA against genomic DNA) on the card, and
    ``refgs``.  (a) gen1 and gen2 in every mode against the JAX f32
    engine's fixtures, K5 launched; (b) K5 against its plain version on
    gen1, gen2 and the medium gene (planes, final band, score and
    knots), the medium gene also on chained clusters forced small; (c)
    the realistic gene, timed only: the wall cold and warm, K5's time and
    microseconds a wave, the host traceback's, peak device memory; (d)
    the long gene on chained clusters (``phase_aln_G_long``); (e) refgs
    on the in-repo family against its fixtures, with the launches of K4,
    K4w, K1, K2 and K3."""
    out = {"modes": {}}
    for case in (1, 2):
        for mode, flags in ALN_G_MODES.items():
            fixture = f"jax_aln_G_gen{case}_{mode}.txt"
            calls, text, secs, counts = capture_aln_G(
                ["-G", *flags, str(FIX / f"gen{case}.fa"),
                 str(FIX / f"cdna{case}.fa")])
            if text != (FIX / fixture).read_text():
                raise AssertionError(f"aln -G {mode} on gen{case} differs "
                                     f"from {fixture}")
            if counts.get("spliced_s_wave", 0) != 1:
                raise AssertionError(f"aln -G {mode} on gen{case}: "
                                     f"{counts} launches")
            out["modes"][f"gen{case}_{mode}"] = counts
            plan = k5_plans(calls["sweep"][0][0])[0]
            emit({"phase": f"aln_G_gen{case}_{mode}", "seconds": secs,
                  "bytes": len(text), "fixture": fixture,
                  "launches": counts, "k5_plan": {
                      k: plan[k] for k in ("variant", "ctas", "rows")}})
            if mode == "default":
                out[f"gen{case}"] = calls["sweep"][0]
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        introns = {}
        for name in GENES:
            genome, cdna, introns[name] = spliced_gene(name)
            out[name] = (write_fasta(tmp / f"{name}_genome.fa",
                                     f"{name}_genome", genome),
                         write_fasta(tmp / f"{name}_cdna.fa", f"{name}_cdna",
                                     cdna))
        # (b) K5 against its plain version, both variants: on the card
        # for gen2 (its time there is the kernels line's plain_ms), on a
        # CPU copy of the inputs for gen1 and the medium gene
        for name in ("gen1", "gen2", "medium"):
            if name == "medium":
                calls, _, _, _ = capture_aln_G(["-G", "-O", "4",
                                                *out["medium"]])
                ins, sw = calls["sweep"][0]
            else:
                ins, sw = out[name]
            plan, gplan = k5_plans(ins)
            # the medium gene also under chained plans forced small: 5
            # clusters of 2 CTAs of 64 rows, in one launch and in passes
            cplans = {}
            if name == "medium":
                cplans = {k: SS.sweep_s_plan(ins.rows, ins.mtx.shape[0],
                                             ins.lb + 2, variant="chained",
                                             **kw)
                          for k, kw in K5_CHAINED.items()}
            chk = k5_check(name, ins, [sw, SS._launch_sweep_s(ins, gplan),
                                       *(SS._launch_sweep_s(ins, cp)
                                         for cp in cplans.values())],
                           on_card=name == "gen2")
            ms = time_ms(lambda: SS._launch_sweep_s(ins), 5)
            gms = time_ms(lambda: SS._launch_sweep_s(ins, gplan), 5)
            entry = {"max_abs_err": chk["max_abs_err"], "ms": ms,
                     "plain_ms": chk["plain_ms"], **k5_bound(ins, sw),
                     "global_ms": gms}
            if "plain_cpu_ms" in chk:
                entry["plain_cpu_ms"] = chk["plain_cpu_ms"]
            for k, cp in cplans.items():
                cms = time_ms(lambda c=cp: SS._launch_sweep_s(ins, c), 5)
                entry[f"chained_{k}"] = k5_launch(cp, ins, cms)
            emit({"phase": f"k5_{name}", "rows": ins.rows, "W": ins.W,
                  "genome": ins.lb, "waves": ins.waves,
                  "band_cells": ins.band_cells, "planes_equal": True,
                  "band_equal": True, "knots_equal": True,
                  "global_equal": True, "knots": chk["knots"], "k5": entry,
                  "k5_launch": k5_launch(plan, ins, ms),
                  "k5_global": k5_launch(gplan, ins, gms)})
            out[f"k5_{name}"] = {**entry, "plan": {
                k: plan[k] for k in ("variant", "ctas", "rows")}}
        # (c) the realistic gene: walls, and K5's default plan held to its
        # global variant on the card
        walls = {}
        calls = None
        for run in ("cold", "warm"):
            calls = None           # the last run's planes are not held
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            calls, text, secs, counts = capture_aln_G(
                ["-G", "-O", "4", *out["realistic"]])
            walls[run] = {"seconds": secs, "launches": counts,
                          "traceback_s": calls["traceback_s"],
                          "peak_mb": torch.cuda.max_memory_allocated() / 1e6}
        ins, sw = calls["sweep"][0]
        plan, gplan = k5_plans(ins)
        gsw = SS._launch_sweep_s(ins, gplan)
        if not k5_same(sw, gsw):
            raise AssertionError("K5's default plan != its global variant "
                                 "on the realistic gene")
        del gsw
        ms = time_ms(lambda: SS._launch_sweep_s(ins), 5)
        gms = time_ms(lambda: SS._launch_sweep_s(ins, gplan), 3)
        emit({"phase": "aln_G_realistic", "rows": ins.rows, "W": ins.W,
              "genome": ins.lb, "waves": ins.waves,
              "band_cells": ins.band_cells,
              "planes_mb": tensor_bytes(sw.ev, sw.jdon) / 1e6,
              "introns": introns["realistic"], "output_lines":
              len(text.splitlines()), "walls": walls,
              "global_equal": plan["variant"] != "global", "k5_ms": ms,
              "k5_us_per_wave": ms * 1e3 / ins.waves,
              "gcups": ins.band_cells / (ms * 1e6),
              "k5_bound": k5_bound(ins, sw),
              "k5_launch": k5_launch(plan, ins, ms),
              "k5_global": k5_launch(gplan, ins, gms)})
        out["realistic_k5"] = {"ms": ms, "global_ms": gms,
                               **k5_bound(ins, sw), "plan": {
                                   k: plan[k] for k in
                                   ("variant", "ctas", "rows")}}
        del calls, sw, ins
        # (d) the long gene on chained clusters
        out["long_k5"] = phase_aln_G_long(out["long"], introns["long"])
        # (e) refgs on the in-repo family
        from prrn_aln_tpu_torch import refgs as rg
        from prrn_aln_tpu_torch.cli import refgs_main
        from prrn_aln_tpu_torch.io import SeqRecord
        g, fam = refgs_family_inputs()
        members = [SeqRecord(n_, s_, exons=e_) for n_, s_, e_ in fam]

        def genome_of(name):
            return (g, 0) if name == "ce13a1" else None

        bad = [SeqRecord(members[0].name, members[0].seq,
                         exons=list(REFGS_BAD)), *members[1:]]
        for case, kw, need in (
                ("ok", dict(records=members, rebuild=False),
                 ("spliced_h_wave", "spliced_h_walk")),
                ("perturbed", dict(records=bad, rebuild=True),
                 ("spliced_h_wave", "spliced_h_walk", "pairwise",
                  "group_wavefront", "traceback"))):
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rg.refgs_family(kw["records"], genome_of, iters=2,
                                  rebuild=kw["rebuild"],
                                  device=torch.device("cuda"))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
            fixture = f"jax_refgs_{case}.txt"
            if refgs_text(res) != (FIX / fixture).read_text():
                raise AssertionError(f"refgs {case} differs from {fixture}")
            for k in need:
                if counts.get(k, 0) <= 0:
                    raise AssertionError(f"refgs {case} never launched {k}")
            out[f"refgs_{case}"] = counts
            emit({"phase": f"refgs_{case}", "seconds": secs,
                  "fixture": fixture, "launches": counts})
        fam_path, gen = write_refgs_inputs(tmp, g, fam)
        res_path = tmp / "refgs_out.fa"
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            _, secs, counts = run_cli(refgs_main, [
                "-n", gen, "-m", "ce13a1", "-I", "1", "-t", str(res_path),
                "-pq", fam_path])
        text = res_path.read_text() + "--- stderr\n" + err.getvalue()
        if text != (FIX / "jax_refgs_cli.txt").read_text():
            raise AssertionError("refgs_main differs from jax_refgs_cli.txt")
        emit({"phase": "refgs_cli", "seconds": secs,
              "fixture": "jax_refgs_cli.txt", "launches": counts})
    print(card_line(), flush=True)
    return out



# phase 15's inputs, copied from tests/fixtures into the runs' input
# directory, and the two it writes there: decomp's bundle (the input of
# test_utils_cli.py's decomp case) and a prosite.dat of two patterns
UTILS_FIXTURES = ("dnafam.fa", "ce13a17_clean.fa", "fam19.fa", "idn_a.fa",
                  "idn_b.fa", "idn_p.fa", "idn_q.fa")
DECOMP_BUNDLE = (">sp|P12345|ABC_HUMAN test\nACDEFG\nHIKL\n"
                 ">seq-2.1 other\nMNPQ\n>plain\nWXYZ\n")
PROSITE_DAT = ("ID   PKC_PHOSPHO_SITE; PATTERN.\nAC   PS00005;\n"
               "PA   [ST]-x-\nPA   [RK].\n//\n"
               "ID   ASN_GLYCOSYLATION; PATTERN.\nAC   PS00001;\n"
               "PA   N-{P}-[ST]-{P}.\n//\n")
UTILS_JSON = "jax_utils_cli.json"


def utils_cases() -> dict:
    """Phase 15's runs of the utility programs: name -> (program, argv).
    Each runs in a directory of its own beside the input directory
    ``in``, which ``write_utils_inputs`` fills; what a run writes into
    its directory is part of its output."""
    i = "../in/"
    cases = {}
    for fam in ("dnafam", "ce13a17_clean", "fam19"):
        for method in ("upgma", "nj"):
            cases[f"phyln_{fam}_{method}"] = ("phyln", ["-m", method,
                                                        f"{i}{fam}.fa"])
    for method in ("upgma", "nj"):
        cases[f"phyln_k_{method}"] = ("phyln", ["-k", "-m", method,
                                                f"{i}ce13a17_aligned.txt"])
    cases.update({
        "iden_dna": ("iden", [f"{i}idn_a.fa", f"{i}idn_b.fa"]),
        "iden_pro": ("iden", [f"{i}idn_p.fa", f"{i}idn_q.fa"]),
        "iden_O0": ("iden", ["-O", "0", "-t", "50", f"{i}idn_a.fa",
                             f"{i}idn_b.fa"]),
        "decomp": ("decomp", ["-p", ".", f"{i}bundle.fa"]),
        "makmdm": ("makmdm", ["150", "-d", "."]),
        "makdbs": ("makdbs", [f"{i}dnafam.fa", "-b", "db"]),
        "rdn_o": ("rdn", ["-d", "-F", "msf", "-o", "out.msf",
                          f"{i}ce13a17_aligned.txt"]),
    })
    for name, flags in {"e": ["-e", "1,3,5"], "d": ["-d"],
                        "c": ["-e", "2,4", "-c"], "jl": ["-j", "l"],
                        "jr": ["-j", "r", "-c"]}.items():
        cases[f"rdn_{name}"] = ("rdn", [*flags, f"{i}ce13a17_aligned.txt"])
    for fmt in ("native", "fasta", "clustal", "phylip", "msf", "gde",
                "nexus"):
        cases[f"rdn_F_{fmt}"] = ("rdn", ["-e", "1,2,7", "-F", fmt,
                                         f"{i}ce13a17_aligned.txt"])
    for name, flags in {"c": ["-c"], "t0": ["-t", "0"], "t2": ["-t", "2"],
                        "O": ["-O"], "r": ["-r"], "z_all": ["-z", "all"],
                        "z_all_max": ["-z", "all,2,1"],
                        "z_named": ["-z", "EcoRI,HaeIII,NoSuch"],
                        "fp": ["-fp", "GGNCC"],
                        "all": ["-c", "-t", "1", "-O", "-r", "-fp",
                                "TTAA"]}.items():
        cases[f"utn_{name}"] = ("utn", [*flags, f"{i}dnafam.fa"])
    for name, flags in {"default": [], "c": ["-c"],
                        "m": ["-m", "[ST]-x-[RK]."],
                        "m_c": ["-m", "N-{P}-[ST]-{P}.", "-c"],
                        "P": ["-P", f"{i}prosite.dat"]}.items():
        cases[f"utp_{name}"] = ("utp", [*flags, f"{i}ce13a17_clean.fa"])
    return cases


def write_utils_inputs(root: Path, aligned: Path) -> Path:
    """The input directory of phase 15's runs, with ``aligned`` (an
    aligned ce13a17) as ``ce13a17_aligned.txt``."""
    inp = root / "in"
    inp.mkdir(parents=True)
    for name in UTILS_FIXTURES:
        (inp / name).write_bytes((FIX / name).read_bytes())
    (inp / "ce13a17_aligned.txt").write_bytes(aligned.read_bytes())
    (inp / "bundle.fa").write_text(DECOMP_BUNDLE)
    (inp / "prosite.dat").write_text(PROSITE_DAT)
    return inp


def run_util(main, argv, workdir: Path) -> dict:
    """One utility run in ``workdir`` (made empty): its standard output
    and error, and the files it wrote there (hex)."""
    workdir.mkdir()
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        os.chdir(here)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}")
    return {"stdout": out.getvalue(), "stderr": err.getvalue(),
            "files": {p.name: p.read_bytes().hex()
                      for p in sorted(workdir.iterdir())}}


def phase_utils_cli() -> dict:
    """Phase 15: the utility programs on the card, each against the JAX
    package's output (``tests/fixtures/jax_utils_cli.json``), with the
    launch counts set to 0 just before each: ``phyln`` launches K1
    (without ``-k``) and the others launch nothing.  Returns each
    ``phyln`` run's launches."""
    from prrn_aln_tpu_torch import cli
    want = json.loads((FIX / UTILS_JSON).read_text())
    launches = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        write_utils_inputs(tmp, FIX / "jax_prrn_ce13a17_clean_R0.txt")
        for name, (prog, argv) in utils_cases().items():
            if prog == "phyln":
                argv = [*argv, "--device", "cuda"]
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run_util(getattr(cli, f"{prog}_main"), argv, tmp / name)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
            if got != want[name]:
                raise AssertionError(f"{name} differs from {UTILS_JSON}")
            k1 = prog == "phyln" and "-k" not in argv
            if (counts.get("pairwise", 0) == 1) != k1 or \
                    sum(counts.values()) != int(k1):
                raise AssertionError(f"{name}: launches {counts}")
            if prog == "phyln":
                launches[name] = counts
            emit({"phase": f"utils_{name}", "seconds": secs,
                  "stdout_bytes": len(got["stdout"]),
                  "files": sorted(got["files"]), "launches": counts})
    print(card_line(), flush=True)
    return launches



# phase 16's band-frontier pairs: tests/test_frontier.py's 96 x 96 pair,
# and a seeded 4 kb DNA sequence against a mutant at band +-256
FRONTIER_DNA_NT = 4000
FRONTIER_DNA_BAND = 256
# ranks a run of phase 16 waits for before it fails
RANK_TIMEOUT_S = 300


def frontier_pairs() -> dict:
    """name -> (a, b, lw, up, u, v, mtx) of phase 16's frontier runs."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 24, 96).astype(np.int32)
    b = rng.integers(0, 24, 96).astype(np.int32)
    mtx = rng.normal(0, 2, (26, 26)).astype(np.float32)
    out = {"pair96": (a, b, -40, 40, 2.0, 9.0, mtx)}
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, FRONTIER_DNA_NT)
    params = default_params(ab.DNA, "prrn")
    dna, _ = scoring.build_matrix(ab.DNA, params)
    codes = ab.encode("ACGT", ab.DNA)
    out["dna4k"] = (codes[base].astype(np.int32),
                    codes[mutate(rng, base)].astype(np.int32),
                    -FRONTIER_DNA_BAND, FRONTIER_DNA_BAND, params.u,
                    params.v, dna.astype(np.float32))
    return out


def sharding_inputs():
    """tests/test_sharding.py's inputs: 9 seeded proteins (36 pairs) and
    five group pairs, with the matrix."""
    mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
    rng = np.random.default_rng(17)
    seqs = [rng.integers(3, 23, size=rng.integers(30, 70)).astype(np.int32)
            for _ in range(9)]
    rows = ["MKVLAAGFDDEERRKKLL", "MKVLAAGFDEEERRKQLL",
            "MKVLAGGFDDEERRKKLL", "MKVLAAGFDDEERRQKLL",
            "MKVLAAGFDDEDRRKKLL", "MKVIAAGFDDEERRKKLL"]
    A, B, C = (msa_from_strings(r, ab.PROTEIN).prepare(mtx.shape[0])
               for r in (rows[:3], rows[3:], [x[2:] for x in rows[:2]]))
    return mtx, seqs, [(A, B), (B, C), (A, C), (C, B), (A, B)]


@contextlib.contextmanager
def frontier_probe(target: int):
    """Wrap K6r's entry point and the ring's messages while a frontier
    score runs: record the inputs of row ``target`` (H, G, the band, the
    four received values; no row at world 1, where K6s sweeps the band in
    one launch) and sum the seconds spent waiting for and posting
    messages."""
    from prrn_aln_tpu_torch.ops import frontier as F
    rec = {"rows": 0, "exchange_s": 0.0, "row": None}
    row, ring_recv, ring_send = F.frontier_row, F._Ring.recv, F._Ring.send

    def frontier_row(H, G, a, b, mtx, recv, **kw):
        if kw["m"] == target:
            rec["row"] = {"H": H.clone(), "G": G.clone(), "a": a, "b": b,
                          "mtx": mtx, "recv": recv, **kw}
        rec["rows"] += 1
        return row(H, G, a, b, mtx, recv, **kw)

    def timed(fn):
        def wrapped(self, *args):
            t0 = time.perf_counter()
            got = fn(self, *args)
            rec["exchange_s"] += time.perf_counter() - t0
            return got
        return wrapped

    F.frontier_row = frontier_row
    F._Ring.recv, F._Ring.send = timed(ring_recv), timed(ring_send)
    try:
        yield rec
    finally:
        F.frontier_row = row
        F._Ring.recv, F._Ring.send = ring_recv, ring_send


def k6r_row_args(row: dict, dev) -> tuple:
    """A recorded row's K6r arguments on ``dev``, and its scores as
    ``band_rows`` packs them for the plain version."""
    from prrn_aln_tpu_torch.ops import frontier as F
    kw = {k: row[k] for k in ("m", "j0", "lw", "W", "u", "v")}
    a, b, mtx = (row[k].to(dev) for k in ("a", "b", "mtx"))
    s_row = torch.as_tensor(F.band_rows(
        row["a"][kw["m"]:kw["m"] + 1].cpu(), row["b"].cpu(),
        kw["lw"] + kw["m"], row["mtx"].cpu(), row["H"].shape[0],
        kw["j0"])[0], device=dev)
    return (row["H"].to(dev), row["G"].to(dev), a, b, mtx,
            tuple(row["recv"])), s_row, kw


def k6r_row_check(row: dict, dev) -> dict:
    """K6r on a recorded row against ``frontier_row_ref`` on the card:
    H0, G0 and the four values the row sends, bit for bit."""
    from prrn_aln_tpu_torch.ops import frontier as F
    args, s_row, kw = k6r_row_args(row, dev)
    got = F.frontier_row(*args, **kw)
    H, G, a, b, mtx, recv = args
    want = F.frontier_row_ref(H, G, s_row, recv, lb=b.shape[0], **kw)
    for x, y in zip(got, want):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"K6r != frontier_row_ref on row {kw['m']} "
                                 f"(j0 {kw['j0']})")
    return {"lanes": H.shape[0], "m": kw["m"], "j0": kw["j0"],
            "max_abs_err": max(float((x - y).abs().max())
                               for x, y in zip(got, want))}


def k6s_inputs(name: str, dev) -> tuple:
    """K6s's arguments for a frontier pair of world 1, as
    ``frontier_pairwise_score`` builds them on ``dev``."""
    from prrn_aln_tpu_torch.ops import frontier as F
    a, b, lw, up, u, v, fmtx = frontier_pairs()[name]
    W = up - lw + 1
    Wl = -(-W // F.LANE_QUANTUM) * F.LANE_QUANTUM
    H, G = F.row_init(0, Wl, lw, up, u, v, dev)
    band = tuple(torch.as_tensor(x, device=dev) for x in (a, b, fmtx))
    return (H, G, *band), {"lw": lw, "W": W, "u": u, "v": v}


def k6s_check(dev) -> dict:
    """K6s against the plain sweep on the card on each frontier pair: the
    last row's H and G bit for bit (the plain sweep of the 4 kb pair,
    ~4,000 rows of small torch ops, is timed once here)."""
    from prrn_aln_tpu_torch.ops import frontier as F
    out = {}
    for name in frontier_pairs():
        args, kw = k6s_inputs(name, dev)
        got = F.frontier_sweep(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = F.frontier_sweep_ref(*args, **kw)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"K6s != the plain sweep on {name}")
        out[name] = {"lanes": args[0].shape[0], "rows": args[2].shape[0],
                     "plan": F.sweep_plan(args[0].shape[0]),
                     "plain_ms": 1e3 * (time.perf_counter() - t0),
                     "max_abs_err": max(float((x - y).abs().max())
                                        for x, y in zip(got, want))}
    return out


def multi_device_cases(group, dev) -> dict:
    """Phase 16's cases on ``dev`` with ``group`` (None: the run with no
    group), each with the launch counts set to 0 just before it:
    the distance pass (K1, then K1f under ``PRRN_PW_FUSED=1``),
    ``group_align_batch`` (K2, K3), ``build_msa`` with ``prrn -R 0``'s
    settings on ce13a17, and the frontier score of each pair, with the
    ring's message counts; where K6r runs (a ring), the middle row is
    recorded and held to the plain version after the run (K6r's launches
    there are not the run's)."""
    from prrn_aln_tpu_torch.ops import frontier as F
    mtx, seqs, pairs = sharding_inputs()
    out = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(name, fn):
        _build.LAUNCHES.clear()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = {"result": res, "seconds": time.perf_counter() - t0,
                     "launches": dict(_build.LAUNCHES)}
        return res

    run("scores", lambda: distance.all_pairs_scores(
        seqs, mtx, 2.0, 9.0, -60, group, device=dev))
    os.environ["PRRN_PW_FUSED"] = "1"
    try:
        run("scores_fused", lambda: distance.all_pairs_scores(
            seqs, mtx, 2.0, 9.0, -60, group, device=dev))
    finally:
        del os.environ["PRRN_PW_FUSED"]
    run("batch", lambda: G.group_align_batch(
        pairs, mtx, u=2.0, v=9.0, sh=-60, pads=(6, 32), group=group,
        device=dev))
    out["batch"]["shard"] = G.LAST_BATCH_SHARD
    recs = pio.sniff_and_read(FIX / "ce13a17_clean.fa")
    molc = ab.infer_molc(recs[0].seq)
    run("msa", lambda: pio.write_native_block(pipeline.build_msa(
        recs, params=default_params(molc, "prrn"), molc=molc, randseed=0,
        group=group, device=dev)))
    for name, (a, b, lw, up, u, v, fmtx) in frontier_pairs().items():
        if group is not None:
            # the ranks start together, so no rank's wall holds its wait
            # for a slower one
            torch.distributed.barrier(group)
        with frontier_probe(len(a) // 2) as rec:
            run(name, lambda: F.frontier_pairwise_score(
                a, b, lw, up, u, v, fmtx, group, device=dev))
        out[name].update(rows=rec["rows"], exchange_s=rec["exchange_s"],
                         ring=dict(F.LAST_RING))
        if rec["row"] is not None:
            out[name]["row_check"] = k6r_row_check(rec["row"], dev)
            out[name]["row"] = {k: (x.cpu() if torch.is_tensor(x) else x)
                                for k, x in rec["row"].items()}
    return out


def multi_device_rank(rank: int, world: int, store: str, out_dir: str,
                      dev: str):
    """One rank of phase 16's run (a spawned process): the cases on a
    gloo group of ``world`` ranks, written to ``out_dir``."""
    import pickle
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = multi_device_cases(dist.group.WORLD, torch.device(dev))
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(world: int, tmp: Path, dev) -> list[dict]:
    """Phase 16's cases in ``world`` spawned ranks, all on ``dev``."""
    import pickle
    import torch.multiprocessing as mp
    ctx = mp.start_processes(multi_device_rank,
                             args=(world, str(tmp / "store"), str(tmp),
                                   str(dev)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world}: the ranks did not end "
                                   f"in {RANK_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def k6_entries(alone: dict, ranks2: list, dev) -> tuple[dict, dict]:
    """K6s and K6r timed on the 4 kb pair (one NVIDIA card's CUDA events
    around calls through the wrappers, and the kernels' own time: for
    K6s, CUDA events around launches queued back to back, as
    ``torch.profiler`` loses events late in a long run; for K6r, whose
    launch costs more than its work, ``torch.profiler`` over the
    launches it recorded), each against
    its plain version and its bound:
    K6s sweeping the band of world 1 (520 lanes, 4,000 rows: a, b, the
    matrix and the first and last rows of H and G moved once, about 14
    float operations a lane and row), K6r on rank 0's recorded middle row
    of world 2 (its lanes of H and G read, H0 and G0 written, a[m], the
    row's codes and the matrix row read, four values sent)."""
    from prrn_aln_tpu_torch.ops import frontier as F
    checks = k6s_check(dev)
    args, kw = k6s_inputs("dna4k", dev)
    H, a, b, mtx = args[0], args[2], args[3], args[4]
    la, Wl, K = a.shape[0], H.shape[0], mtx.shape[0]
    ms = time_ms(lambda: F.frontier_sweep(*args, **kw), 20)
    qms = queued_ms(lambda: F.frontier_sweep(*args, **kw), 20)
    k6s = {"ms": ms, "queued_ms": qms, "ms_a_row": ms / la,
           "queued_us_a_row": 1e3 * qms / la,
           "plan": checks["dna4k"]["plan"], "lanes": Wl, "rows": la,
           "plain_ms": checks["dna4k"]["plain_ms"],
           "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
           **bound(4 * (la + b.shape[0] + K * K) + 4 * 4 * Wl,
                   14 * Wl * la),
           "world1_s": alone["dna4k"]["seconds"], "checks": checks}
    rargs, s_row, rkw = k6r_row_args(ranks2[0]["dna4k"]["row"], dev)
    H, G, a, b, mtx, recv = rargs
    Wl = H.shape[0]
    k6r = {"ms": time_ms(lambda: F.frontier_row(*rargs, **rkw), 50),
           "device_ms": launch_ms(lambda: F.frontier_row(*rargs, **rkw), 50,
                                  "frontier_row"),
           "plain_ms": time_ms(lambda: F.frontier_row_ref(
               H, G, s_row, recv, lb=b.shape[0], **rkw), 5),
           **bound(4 * (1 + (Wl + 1) + K) + 4 * 4 * Wl + 4 * 4, 14 * Wl),
           "lanes": Wl}
    return k6s, k6r


def phase_multi_device(dev) -> dict:
    """Phase 16: the multi-device paths on gloo, world 1 (in this
    process) and world 2 (two spawned ranks), every rank on ``cuda:0``:
    each case equal to the run with no group (scores bit for bit, SKLs,
    the shard each rank took), ``build_msa`` on ce13a17 byte-identical to
    ``jax_prrn_ce13a17_clean_R0.txt``, each frontier score within 1e-3
    relative of K1's on the pair; at world 1 one K6s launch a score, its
    last H and G bit-equal to the plain sweep; at world 2 one K6r launch
    and one read of the four values it sends a row a rank, one message
    each way a row toward a neighbour, and K6r bit-equal to its plain
    version on each rank's recorded middle row.  Prints each frontier
    run's ms a row, K6 launches and the share of the wall spent in the
    ring's messages, then K6s's and K6r's times.  The kernels are built
    before any rank starts."""
    import torch.distributed as dist
    _build.load()
    want_msa = (FIX / "jax_prrn_ce13a17_clean_R0.txt").read_text()
    alone = multi_device_cases(None, dev)
    k1 = {}
    for name, (a, b, lw, up, u, v, fmtx) in frontier_pairs().items():
        k1[name] = float(pairwise.pairwise_scores(
            torch.as_tensor(a[None], device=dev),
            torch.as_tensor(b[None], device=dev), len(a), len(b),
            torch.as_tensor(fmtx, device=dev), u, v, lw=np.array([lw]),
            up=np.array([up]), fused=False)[0])
    runs = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        (tmp / "w1").mkdir()
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp / "w1" / "store"), 1), rank=0, world_size=1)
        try:
            runs[1] = [multi_device_cases(dist.group.WORLD, dev)]
        finally:
            dist.destroy_process_group()
        (tmp / "w2").mkdir()
        runs[2] = spawn_ranks(2, tmp / "w2", dev)

    def bits(x):
        return np.asarray(x, np.float32).view(np.int32).tolist()

    out = {"alone": alone, "k1": k1}
    for name, (a, *_) in frontier_pairs().items():
        for world, res in ((0, alone), (1, runs[1][0])):
            if res[name]["launches"] != {"frontier_sweep": 1}:
                raise AssertionError(f"{name} at world {world or 1}: "
                                     f"{res[name]['launches']}")
        for rank, res in enumerate(runs[2]):
            la, ring = len(a), res[name]["ring"]
            want = {"sent_left": la - 1 if rank else 0,
                    "sent_right": 0 if rank else la,
                    "recv_left": la if rank else 0,
                    "recv_right": 0 if rank else la - 1,
                    "rows": la, "reads": la}
            if res[name]["launches"] != {"frontier_row": la} or \
                    ring != want:
                raise AssertionError(f"{name} at world 2, rank {rank}: "
                                     f"{res[name]['launches']}, {ring}")
    for world, ranks in runs.items():
        for rank, res in enumerate(ranks):
            for key in ("scores", "scores_fused"):
                if bits(res[key]["result"]) != bits(alone[key]["result"]):
                    raise AssertionError(f"world {world} rank {rank}: {key} "
                                         "differ from the run with no group")
            got, want = res["batch"]["result"], alone["batch"]["result"]
            if [k for _, k in got] != [k for _, k in want] or \
                    bits([s for s, _ in got]) != bits([s for s, _ in want]):
                raise AssertionError(f"world {world} rank {rank}: "
                                     "group_align_batch differs")
            per = -(-len(want) // world)
            lo = min(len(want), rank * per)
            if res["batch"]["shard"] != (rank, world, lo,
                                         min(len(want), lo + per)):
                raise AssertionError(f"shard {res['batch']['shard']}")
            if res["msa"]["result"] != want_msa:
                raise AssertionError(f"world {world} rank {rank}: build_msa "
                                     "differs from jax_prrn_ce13a17_clean_"
                                     "R0.txt")
            for name in k1:
                got = res[name]["result"]
                if bits(got) != bits(alone[name]["result"]):
                    raise AssertionError(f"world {world} rank {rank}: the "
                                         f"frontier score of {name} differs")
                if abs(got - k1[name]) > 1e-3 * max(1.0, abs(k1[name])):
                    raise AssertionError(f"{name}: frontier {got} against "
                                         f"K1's {k1[name]}")
            emit({"phase": f"multi_device_w{world}_r{rank}",
                  "launches": {k: res[k]["launches"] for k in
                               ("scores", "scores_fused", "batch", "msa")},
                  "seconds": {k: res[k]["seconds"] for k in
                              ("scores", "scores_fused", "batch", "msa")},
                  "shard": res["batch"]["shard"], "frontier": {
                      name: {"score": res[name]["result"], "k1": k1[name],
                             "rows": len(frontier_pairs()[name][0]),
                             "seconds": res[name]["seconds"],
                             "ms_a_row": 1e3 * res[name]["seconds"]
                             / len(frontier_pairs()[name][0]),
                             "exchange_share": res[name]["exchange_s"]
                             / res[name]["seconds"],
                             "launches": res[name]["launches"],
                             "ring": res[name]["ring"],
                             "row_check": res[name].get("row_check")}
                      for name in k1}})
        out[world] = ranks
    out["k6s"], out["k6r"] = k6_entries(alone, runs[2], dev)
    w2 = runs[2][0]["dna4k"]
    emit({"phase": "multi_device_k6", "k6s": {
              k: out["k6s"][k] for k in ("ms", "queued_ms", "ms_a_row",
                                         "queued_us_a_row", "plain_ms",
                                         "bound_ms", "plan", "checks")},
          "k6r": out["k6r"], "dna4k_world1_s": alone["dna4k"]["seconds"],
          "dna4k_world1_gloo_s": runs[1][0]["dna4k"]["seconds"],
          "dna4k_world2_s": w2["seconds"],
          "dna4k_world2_ms_a_row": 1e3 * w2["seconds"] / w2["rows"] if
          w2["rows"] else None,
          "dna4k_world2_exchange_share": w2["exchange_s"] / w2["seconds"]})
    print(card_line(), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": _build.library_path().name})

    bench_args, bench_cells = phase_k1(dev)
    phase_k2k3(dev)
    runs = phase_main()
    k1, k2, k3 = phase_main_shapes()
    forest_runs, edge_args, k2_widest = phase_forest()
    k2_fam19 = phase_fam19_k2(k2_widest)
    del k2_widest
    k1f = phase_k1f(dev, bench_args, bench_cells, edge_args)
    phase_forest_shape()
    aln_runs = phase_aln()
    k4, k4w = phase_k4()["win_msa"]
    k4_long = phase_k4_long_introns()
    phase_flagship()
    k4_chained = phase_aln_yl2_long_protein()
    k2_long, walk_entry = phase_long_pair(dev)
    cli = phase_cli_modes()
    aln_G = phase_aln_G()
    phyln = phase_utils_cli()
    multi = phase_multi_device(dev)

    def cli_launches(name):
        return {mode: c[name] for mode, c in cli.items() if c.get(name)}

    launches = runs["cold"]["launches"]
    aln_launches = aln_runs[("win_msa", "cold")]
    kernels = [
        {"name": "pairwise_scores", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/pairwise.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_pairwise.py:123",
         "launches": launches["pairwise"], **k1,
         "fam19_edges": {"launches": forest_runs["cold"]["pairwise"],
                         "ms": k1f["k1_ms"]},
         "cli_modes": cli_launches("pairwise"),
         "phyln": {name: c["pairwise"] for name, c in phyln.items()
                   if c.get("pairwise")}},
        {"name": "pairwise_rows", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/pairwise_rows.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_pairwise.py:341",
         "launches": forest_runs["fused"]["pairwise_rows"],
         **{k: x for k, x in k1f.items() if k != "k1_ms"},
         "cli_modes": cli_launches("pairwise_rows")},
        {"name": "group_wavefront", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/group_wavefront.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_group.py:102",
         "launches": launches["group_wavefront"], **k2,
         "fam19": {"launches": forest_runs["cold"]["group_wavefront"],
                   **k2_fam19},
         "long_pair": k2_long, "cli_modes": cli_launches("group_wavefront")},
        {"name": "traceback", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/traceback.cu",
         "replaces": "prrn_aln_tpu/ops/group.py:595",
         "launches": launches["traceback"], **k3,
         "fam19": {"launches": forest_runs["cold"]["traceback"],
                   "sum_ms": forest_runs["cold_k3_ms"]},
         "cli_modes": cli_launches("traceback")},
        walk_entry,
        {"name": "spliced_h_wave", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/spliced_h_wave.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_spliced_h.py:201",
         "launches": aln_launches["spliced_h_wave"], **k4,
         "long_introns": {v: k4_long[v] for v in K4_LONG_INTRON_PLANS}},
        k4_chained_entry(k4_chained, k4_long),
        {"name": "spliced_h_walk", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/spliced_h_walk.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_spliced_h.py:1016",
         "launches": aln_launches["spliced_h_walk"], **k4w},
        {"name": "spliced_s_wave", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/spliced_s_wave.cu",
         "replaces": "prrn_aln_tpu/ops/spliced_jax.py:73",
         "launches": aln_G["modes"]["gen2_default"]["spliced_s_wave"],
         **{k: x for k, x in aln_G["k5_gen2"].items()},
         "medium": aln_G["k5_medium"], "realistic": aln_G["realistic_k5"],
         "long": aln_G["long_k5"],
         "refgs": {"ok": aln_G["refgs_ok"],
                   "perturbed": aln_G["refgs_perturbed"]}},
        {"name": "frontier_sweep", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/frontier_sweep.cu",
         "replaces": "prrn_aln_tpu/ops/frontier.py:51",
         "launches": multi["alone"]["dna4k"]["launches"]["frontier_sweep"],
         **{k: x for k, x in multi["k6s"].items() if k != "checks"}},
        {"name": "frontier_row", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/frontier_sweep.cu",
         "replaces": "prrn_aln_tpu/ops/frontier.py:51",
         "launches": multi[2][0]["dna4k"]["launches"]["frontier_row"],
         "max_abs_err": max(r[name]["row_check"]["max_abs_err"]
                            for r in multi[2] for name in ("pair96", "dna4k")),
         **multi["k6r"],
         "world2_ms_a_row": 1e3 * multi[2][0]["dna4k"]["seconds"]
         / multi[2][0]["dna4k"]["rows"],
         "world2_exchange_share": multi[2][0]["dna4k"]["exchange_s"]
         / multi[2][0]["dna4k"]["seconds"]},
    ]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
