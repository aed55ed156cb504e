#!/usr/bin/env python3
"""Smoke test of the PyTorch and CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

0. device: CUDA must be available; prints the card and its power limit;
1. build: compiles the six CUDA kernels from ``prrn_aln_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once);
2. K1 (pairwise DP) against its plain PyTorch version on the card, on the
   pairwise fixtures and on 512 random pairs of 512 x 512 at sh=-60,
   with kernel and plain times and GCUPS;
3. K2 (group wavefront) and K3 (traceback) against their plain versions
   on the card, on the galign fixtures (ls=1 and ls=3) and a batch of 32
   pairs of 8 members x 384 columns;
4. the main path: ``prrn -R 0`` on ce13a17_clean.fa through the kernels,
   cold and warm, byte-identical to the JAX package's output fixture,
   every golden row exact, and every kernel launched;
5. every kernel call of a third ``prrn -R 0`` run, recorded with its
   inputs, against the plain version on the card, and each kernel's time
   at the main path's shapes;
6. the forest path (16 or more sequences): ``prrn -R 0`` on fam19.fa
   (19 proteins) through the kernels, byte-identical to the JAX
   package's output fixture, K1, K2 and K3 launched; then the same run
   once more under ``PRRN_PW_FUSED=1``: K1f launched and K1 not, the
   same edge list and forest, the same bytes; stage walls and summed
   kernel times of both runs (a run takes two minutes, so the second,
   warm run is the one under the switch);
7. K1f (row-sweep pairwise DP) against its plain version on the card,
   bit for bit, on the global pairwise fixtures, on phase 2's 512 pairs
   and on the edge batch recorded in phase 6; against K1 on the last
   two, at most 4 f32 ulp at the DP's scale; K1 and K1f times and GCUPS
   on the same inputs;
8. the forest path's shape, timing only: 64 seeded proteins of 150-250
   residues in 8 families through ``prrn -R 0 -I 0`` (no refinement,
   which at 64 members would outlast the script): the device k-mer pass,
   edges, tree sizes, jobs per batched launch, stage walls, kernel times;
9. K4 (spliced sweep) and K4w (its walk) against their plain versions on
   the card, on the inputs ``aln -yl2`` gives them for (a) mini_gen x
   mini_pro and (c) the 2.3 kb CET10B9 window x the ce13a.msa profile:
   planes, final band and knots equal; times.  On (b), the window x
   ce13a1, the kernels are timed and not held to the plain sweep (it
   takes over a minute there; the output of (b) is still held to its
   fixture in phase 10);
10. the gene-prediction path: ``aln -yl2`` on (a), (b) and (c) through
   the kernels, cold and warm, byte-identical to the JAX package's
   output fixtures (and mini's ``-O 5``/``-O 1`` to the reference's),
   both kernels launched;
11. the flagship's shape, timing only: a 34.9 kb genome (the window at
   31,400 in seeded random flanks) x ce13a.msa.

Prints one JSON line per phase, then the card line, the kernels line
(launches from the cold runs of phases 4 and 10 and, for K1f, from the
run under the switch in phase 6; times at the main paths' shapes,
bounds from the same inputs) and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
import contextlib
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
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa import distance, kmer, progressive, slforest, tree
from prrn_aln_tpu_torch.msa.msa import Msa, msa_from_strings
from prrn_aln_tpu_torch.ops import _build, group as G, pairwise
from prrn_aln_tpu_torch.ops import spliced_h as SH
from prrn_aln_tpu_torch.ops.window import stripe

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
# NVIDIA's data sheet (H100 SXM, at 700 W): device memory rate and the
# float32 rate outside the tensor cores
MEM_BPS = 3.35e12
F32_OPS = 67e12
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


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its float operations over the f32 rate.  No
    PyTorch call computes a banded DP, so there is no library time."""
    tb = nbytes / MEM_BPS * 1e3
    to = nops / F32_OPS * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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
    emit({"phase": "k1_bench", "pairs": B, "len": L, "sh": -60,
          "band_cells": cells, "ms": ms, "plain_ms": plain_ms,
          "gcups": cells / (ms * 1e6), "plain_gcups": cells / (plain_ms * 1e6),
          "max_abs_err": err})
    return (A, Bm, la, lb, lw, up, mt, u, v, tg, exg), cells


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
    sets = [("galign", case_pairs(gfix["cases"]), False, None),
            ("galign_ls3", case_pairs(ls3fix["cases"]), True,
             [c["score"] for c in ls3fix["cases"]]),
            ("batch32_8x384", batch32, False, None)]
    err2 = 0.0
    err3 = 0
    timing = {}
    for name, pairs, ls3, want in sets:
        an_pad = max(max(A.many, B.many) for A, B in pairs)
        la_max = lb_max = G._bucket(max(max(A.length, B.length)
                                        for A, B in pairs))
        wd = [stripe(A.length, B.length, -60) for A, B in pairs]
        nslot = G._bucket(max(w.up - w.lw + 3 for w in wd), 128)
        nsteps = G._bucket(max(A.length + B.length + 1 for A, B in pairs),
                           256)
        items = [G._pack_inputs(A, B, mtx, 2.0, 9.0, w, an_pad, an_pad,
                                la_max, lb_max, spb=20.0,
                                ls=3 if ls3 else 1)
                 for (A, B), w in zip(pairs, wd)]
        ins = G.stack_inputs(items, dev)
        kw = dict(nslot=nslot, nsteps=nsteps, ls3=ls3)
        sk, dk, ok = G.group_wavefront(ins, **kw)
        sr, dr, orf = G.group_wavefront_ref(ins, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dr) and torch.equal(ok, orf)):
            raise AssertionError(f"K2 planes != plain on {name}")
        # the JAX package's own tolerance (tests/test_pallas_group.py)
        torch.testing.assert_close(sk, sr, rtol=1e-5, atol=1e-3)
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
              "planes_equal": True, "skls_equal": True,
              "score_max_abs_err": float((sk - sr).abs().max())})
        if name == "batch32_8x384":
            timing["k2_ms"] = time_ms(lambda: G.group_wavefront(ins, **kw), 5)
            timing["k2_plain_ms"] = time_once_ms(
                lambda: G.group_wavefront_ref(ins, **kw))
            timing["k3_ms"] = time_ms(
                lambda: G.traceback(*tb, max_iters=mi), 7)
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
    its one call; K2 and K3: the call with the most member pairs)."""
    calls = capture_main_path()
    k1_err = 0.0
    for args, _, out in calls["pairwise"]:
        ref = pairwise._plain_pairwise(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError("K1 != plain on the main path's call")
        k1_err = max(k1_err, float((out - ref).abs().max()))
    k2_err = 0.0
    for (ins,), kw, (score, dirs, opens) in calls["group_wavefront"]:
        sr, dr, orf = G.group_wavefront_ref(ins, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(dirs, dr) and torch.equal(opens, orf)):
            raise AssertionError("K2 planes != plain on a main-path call")
        torch.testing.assert_close(score, sr, rtol=1e-5, atol=1e-3)
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
          "plain_ms": time_ms(lambda: pairwise._plain_pairwise(*k1_args), 5),
          **bound(tensor_bytes(*(x for x in k1_args
                                 if isinstance(x, torch.Tensor)))
                  + 4 * a_batch.shape[0], 9 * k1_cells)}

    def width(call):
        ins = call[0][0]
        return ins["wa"].shape[1] * ins["wb"].shape[1], call[1]["nsteps"]

    k = max(range(len(calls["group_wavefront"])),
            key=lambda i: width(calls["group_wavefront"][i]))
    (ins,), kw, (_, dirs, _) = calls["group_wavefront"][k]
    Bn, _, C = ins["CA"].shape
    an, bn = ins["wa"].shape[1], ins["wb"].shape[1]
    k2_cells = pairwise.band_cells(*(ins[x].cpu().numpy()
                                     for x in ("la", "lb", "lw", "up")))
    # a band cell: the C-channel profile product (a multiply and an add
    # each), three gap-open sums over the member pairs and the lane update
    k2 = {"max_abs_err": k2_err,
          "ms": time_ms(lambda: G.group_wavefront(ins, **kw), 7),
          "plain_ms": time_once_ms(lambda: G.group_wavefront_ref(ins, **kw)),
          **bound(tensor_bytes(*ins.values()) + 4 * Bn + 2 * dirs.numel(),
                  k2_cells * (2 * C + 6 * an * bn + 9))}
    tb_args, tb_kw, (_, cnts) = calls["traceback"][k]
    # a move reads one dirs and one opens byte and writes one move byte
    k3 = {"max_abs_err": k3_err,
          "ms": time_ms(lambda: G.traceback(*tb_args, **tb_kw), 7),
          "plain_ms": time_ms(lambda: G.traceback_ref(*tb_args, **tb_kw), 5),
          **bound(3 * int(cnts.sum()) + 4 * cnts.numel(), 0)}
    emit({"phase": "main_path_kernels",
          "calls": {name: len(c) for name, c in calls.items()},
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
           collections.defaultdict(list), "jobs": [], "edge_args": None}

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
        (G, "group_wavefront", lambda f: evented("group_wavefront", f)),
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
    return ({"cold": runs["cold"][0], "fused": runs["fused"][0]},
            runs["fused"][1]["edge_args"][1])


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


def k1f_against_k1(name: str, args: tuple, cells: int) -> dict:
    """K1f on one batch: bit for bit against its plain version, within 4
    ulp (at the DP's scale) of K1, and both kernels' times."""
    la, lb, lw, up = args[2:6]
    u, v = args[7:9]
    lw0 = int(lw.min())
    rows = lambda: pairwise._launch_rows(*args, lw0)          # noqa: E731
    plain = lambda: pairwise._plain_rows(*args, lw0)          # noqa: E731
    wave = lambda: pairwise._launch_pairwise(*args, False)    # noqa: E731
    got, ref, k1 = rows(), plain(), wave()
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K1f != plain on {name}: max diff "
                             f"{float((got - ref).abs().max())}")
    ulps = ulp_diffs(got, k1, la, lb, u, v)
    if ulps["max_ulp_at_dp_scale"] > 4:
        raise AssertionError(f"K1f differs from K1 on {name}: {ulps}")
    out = {"max_abs_err": float((got - ref).abs().max()),
           "ms": time_ms(rows, 7), "k1_ms": time_ms(wave, 7),
           "plain_ms": time_ms(plain, 3),
           # a band cell: as K1, 3 adds or subtractions and 6 maxima
           **bound(tensor_bytes(*args) + 4 * args[0].shape[0], 9 * cells)}
    emit({"phase": f"k1f_{name}", "pairs": args[0].shape[0],
          "lanes": int(up.max()) - lw0 + 1, "rows": int(la.max()),
          "band_cells": cells, "equals_plain": True, "vs_k1": ulps,
          "gcups": cells / (out["ms"] * 1e6),
          "k1_gcups": cells / (out["k1_ms"] * 1e6), **out})
    return out


def phase_k1f(dev, bench_args, bench_cells, edge_args) -> dict:
    """K1f against its plain version and against K1; returns its entry
    for the kernels line (the fam19 edge batch)."""
    ncase = 0
    for molc, local, cases, args in pairwise_fixture_sets(dev):
        if local:
            continue                 # the row sweep has no local mode
        lw0 = int(args[4].min())
        got = pairwise._launch_rows(*args, lw0)
        ref = pairwise._plain_rows(*args, lw0)
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
    edge_args = edge_args[:11]
    cells = pairwise.band_cells(*(x.cpu().numpy() for x in edge_args[2:6]))
    return k1f_against_k1("fam19_edges", edge_args, cells)


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
        k4w = {"max_abs_err": 0.0, "ms": time_ms(
            lambda: SH._launch_walk(*wargs), 7), "plain_ms": walk_plain_ms,
            **b4w}
        emit({"phase": f"k4_{name}", "waves": ins.waves, "rows": ins.M + 1,
              "genome": ins.N, "band_cells": ins.band_cells,
              "planes_equal": plain_ms is not None,
              "band_equal": plain_ms is not None, "knots_equal": True,
              "knots": len(wk.knots), "walk_steps": wk.steps,
              "k4": k4, "k4w": k4w})
        out[name] = (k4, k4w)
    return out


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
        path = Path(tmp) / "flagship_shape.fa"
        path.write_text(">flagship_shape\n" + "\n".join(
            genome[i:i + 60] for i in range(0, len(genome), 60)) + "\n")
        calls, text, secs = capture_aln(["-yl2", str(path),
                                         str(FIX / "ce13a.msa")])
    (ins,), sw = calls["sweep"][0]
    wargs, wk = calls["walk"][0]
    ms = time_ms(lambda: SH._launch_sweep(ins), 3)
    wms = time_ms(lambda: SH._launch_walk(*wargs), 5)
    exons = "".join(line[3:] for line in text.splitlines()
                    if line.startswith(";C "))
    b4, b4w = k4_bounds(ins, sw, wk)
    emit({"phase": "flagship_shape", "genome": ins.N, "rows": ins.M + 1,
          "waves": ins.waves, "band_cells": ins.band_cells,
          "planes_mb": tensor_bytes(sw.ev, sw.jd, sw.V, sw.D) / 1e6,
          "wall_s": secs, "k4_ms": ms, "k4w_ms": wms,
          "gcups": ins.band_cells / (ms * 1e6), "k4_bound_ms": b4["bound_ms"],
          "k4w_bound_ms": b4w["bound_ms"], "exons": exons})


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
    forest_runs, edge_args = phase_forest()
    k1f = phase_k1f(dev, bench_args, bench_cells, edge_args)
    phase_forest_shape()
    aln_runs = phase_aln()
    k4, k4w = phase_k4()["win_msa"]
    phase_flagship()

    launches = runs["cold"]["launches"]
    aln_launches = aln_runs[("win_msa", "cold")]
    kernels = [
        {"name": "pairwise_scores", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/pairwise.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_pairwise.py:123",
         "launches": launches["pairwise"], **k1},
        {"name": "pairwise_rows", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/pairwise_rows.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_pairwise.py:341",
         "launches": forest_runs["fused"]["pairwise_rows"],
         **{k: x for k, x in k1f.items() if k != "k1_ms"}},
        {"name": "group_wavefront", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/group_wavefront.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_group.py:102",
         "launches": launches["group_wavefront"], **k2},
        {"name": "traceback", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/traceback.cu",
         "replaces": "prrn_aln_tpu/ops/group.py:595",
         "launches": launches["traceback"], **k3},
        {"name": "spliced_h_wave", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/spliced_h_wave.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_spliced_h.py:201",
         "launches": aln_launches["spliced_h_wave"], **k4},
        {"name": "spliced_h_walk", "route": "cuda",
         "source": "prrn_aln_tpu_torch/csrc/spliced_h_walk.cu",
         "replaces": "prrn_aln_tpu/ops/pallas_spliced_h.py:1016",
         "launches": aln_launches["spliced_h_walk"], **k4w},
    ]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
