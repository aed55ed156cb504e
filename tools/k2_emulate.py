#!/usr/bin/env python3
"""Rehearse kernel K2 (``csrc/group_wavefront.cu``) on the CPU, every CUDA
thread a ``std::thread``, and hold it bit for bit to its plain version.

Run from the repository root (needs ``g++``; no card, no ``nvcc``):

    python3 tools/k2_emulate.py                   # AddressSanitizer
    python3 tools/k2_emulate.py --sanitize thread # ThreadSanitizer
    python3 tools/k2_emulate.py --cases ls3_p3 --src DIR  # other sources

The source up to the end of its first anonymous namespace (the kernels
and their device helpers) is compiled with ``g++ -std=c++17
-ffp-contract=off`` after a header that defines the CUDA keywords,
``threadIdx``/``blockIdx``/``blockDim`` as ``thread_local`` values,
``extern __shared__`` as one buffer a CTA of exactly its bytes, and
``__syncthreads`` and the split cluster barrier (``barrier.cluster.arrive
.release`` / ``wait.acquire``, swapped in for the inline PTX by this
script) as spin barriers on ``std::atomic`` alone (``std::barrier``'s
waits share hashed mutexes in libstdc++, which give ThreadSanitizer a
happens-before that hides a missing wait).  ``cg::this_cluster()``'s
``map_shared_rank`` returns the same offset in another CTA's buffer.  A
launch runs each pair's CTAs (a cluster's all at once) as threads, and
threads really race between barriers, so a missing barrier shows as
planes that differ or as a report of a race.

Each case packs seeded random groups (DNA and protein, one and several
members, ls 1 and 3) with the port's ``_pack_inputs``, runs the variant
and plan it names in the emulation from the DP corner or from the plain
version's carry at an odd step, and compares score, dirs, opens and the
output carry with ``group_wavefront_ref`` bit for bit.  ``--mutate``
builds a broken copy of the source (a barrier or a push taken out) to
show that the cases catch it.  Prints one JSON line a case and exits
non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from prrn_aln_tpu_torch import alphabet as ab, scoring  # noqa: E402
from prrn_aln_tpu_torch.config import AlnParams, default_params  # noqa: E402
from prrn_aln_tpu_torch.msa.msa import Msa  # noqa: E402
from prrn_aln_tpu_torch.ops import group as G  # noqa: E402
from prrn_aln_tpu_torch.ops.window import stripe  # noqa: E402

HEADER = r"""
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
using std::max;
using std::min;
struct dim3 { unsigned x = 1, y = 1, z = 1; };
typedef int cudaError_t;
namespace emu {
// a barrier on std::atomic alone; arrive returns the phase to wait on
struct Spin {
  std::atomic<int> count{0}, gen{0};
  int total = 0;
  int arrive() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == total) {
      count.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
    }
    return g;
  }
  void wait(int g) {
    while (gen.load(std::memory_order_acquire) == g)
      std::this_thread::yield();
  }
};
struct Ctx {
  dim3 tid, bid, bdim;
  float* smem;
  float** cluster_smem;
  Spin *cta, *cluster;
  int rank, nblocks, phase;
};
thread_local Ctx ctx;
inline void syncthreads() { ctx.cta->wait(ctx.cta->arrive()); }
}  // namespace emu
#define threadIdx (emu::ctx.tid)
#define blockIdx (emu::ctx.bid)
#define blockDim (emu::ctx.bdim)
#define __syncthreads() emu::syncthreads()
#define __ldg(p) (*(p))
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::ctx.rank; }
  unsigned num_blocks() const { return emu::ctx.nblocks; }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(emu::ctx.cluster_smem[r]) +
        (reinterpret_cast<char*>(p) -
         reinterpret_cast<char*>(emu::ctx.smem)));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

DRIVER = r"""
namespace {
template <class K>
void run_blocks(K kernel, const Args& args, int grid, int per_cluster,
                int threads, size_t smem) {
  // the clusters one after another, a cluster's CTAs and threads at once
  for (int c0 = 0; c0 < grid; c0 += per_cluster) {
    std::vector<float*> bufs(per_cluster);
    std::vector<emu::Spin> ctas(per_cluster);
    emu::Spin cluster;
    cluster.total = per_cluster * threads;
    for (int r = 0; r < per_cluster; ++r) {
      bufs[r] = (float*)malloc(smem ? smem : 1);
      memset(bufs[r], 0xa5, smem);   // poison: a read before a write shows
      ctas[r].total = threads;
    }
    std::vector<std::thread> pool;
    for (int r = 0; r < per_cluster; ++r)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, r, t] {
          emu::ctx.tid.x = t;
          emu::ctx.bid.x = c0 + r;
          emu::ctx.bdim.x = threads;
          emu::ctx.smem = bufs[r];
          emu::ctx.cluster_smem = bufs.data();
          emu::ctx.cta = &ctas[r];
          emu::ctx.cluster = &cluster;
          emu::ctx.rank = r;
          emu::ctx.nblocks = per_cluster;
          kernel(args);
        });
    for (auto& th : pool) th.join();
    for (auto* b : bufs) free(b);
  }
}

template <bool LS3>
void launch_emu(const Args& args, int B, int variant, int run_bytes,
                int threads) {
  if (variant == V_CLUSTER) {
    const size_t smem = cluster_smem_bytes(LS3, run_bytes, args.an_max,
                                           args.bn_max, args.pc);
    if (run_bytes == 2)
      run_blocks(group_wavefront_cluster<LS3, 2>, args, B * args.ctas,
                 args.ctas, threads, smem);
    else if (run_bytes == 4)
      run_blocks(group_wavefront_cluster<LS3, 4>, args, B * args.ctas,
                 args.ctas, threads, smem);
    else
      run_blocks(group_wavefront_cluster<LS3, 0>, args, B * args.ctas,
                 args.ctas, threads, smem);
    return;
  }
  const size_t smem =
      smem_bytes(LS3, variant, args.an_max, args.bn_max, args.nslot);
  if (variant == V_SHARED)
    run_blocks(group_wavefront_kernel<LS3, V_SHARED>, args, B, 1, threads,
               smem);
  else if (variant == V_WIDE)
    run_blocks(group_wavefront_kernel<LS3, V_WIDE>, args, B, 1, threads,
               smem);
  else
    run_blocks(group_wavefront_kernel<LS3, V_GLOBAL>, args, B, 1, threads,
               smem);
}

std::vector<void*> taken;

template <class T>
T* take(FILE* f, size_t n) {
  T* p = (T*)malloc(n * sizeof(T) + 1);
  taken.push_back(p);
  if (fread(p, sizeof(T), n, f) != n) { fprintf(stderr, "short input\n"); exit(2); }
  return p;
}
}  // namespace

// argv[1]: the packed inputs (python side: ``pack``); argv[2]: outputs
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[17];
  if (fread(h, sizeof(int), 17, f) != 17) return 2;
  const int B = h[0], C = h[1], an = h[2], bn = h[3], an_max = h[4],
            bn_max = h[5], la_max = h[6], lb_max = h[7], nslot = h[8],
            nsteps = h[9], d0 = h[10], ls3 = h[11], variant = h[12],
            ctas = h[13], run_bytes = h[14], threads = h[15],
            has_carry = h[16];
  const size_t nrun = run_words(ls3, an_max, bn_max, nslot);
  const int npairs = (nslot + 1) / 2;
  auto* CA = take<double>(f, (size_t)B * C * la_max);
  auto* CB = take<double>(f, (size_t)B * C * lb_max);
  auto* XA = take<double>(f, (size_t)B * an * NCOMP * (la_max + 1));
  auto* YB = take<double>(f, (size_t)B * bn * NCOMP * (lb_max + 1));
  auto* ea0 = take<float>(f, (size_t)B * la_max);
  auto* eb0 = take<float>(f, (size_t)B * lb_max);
  auto* cfa = take<float>(f, (size_t)B * (la_max + 1));
  auto* efa = take<float>(f, (size_t)B * (la_max + 1));
  auto* cfb = take<float>(f, (size_t)B * (lb_max + 1));
  auto* efb = take<float>(f, (size_t)B * (lb_max + 1));
  auto* iprm = take<int32_t>(f, (size_t)B * 7);
  auto* fprm = take<float>(f, (size_t)B * 4);
  float* vals0 = nullptr;
  int8_t* hdir0 = nullptr;
  int32_t* runs0 = nullptr;
  if (has_carry) {
    vals0 = take<float>(f, (size_t)B * 5 * nslot);
    hdir0 = take<int8_t>(f, (size_t)B * nslot);
    runs0 = take<int32_t>(f, (size_t)B * nrun);
  }
  fclose(f);
  std::vector<float> score(B);
  std::vector<int8_t> dirs((size_t)B * nsteps * nslot, 99),
      opens((size_t)B * nsteps * nslot, 99);
  std::vector<float> valsf((size_t)B * 5 * nslot, 7.0f);
  std::vector<int8_t> hdirf((size_t)B * nslot, 99);
  std::vector<int32_t> runsf(B * nrun, -7);
  std::vector<float> span((size_t)B * kSpan * npairs);
  const int pc = (npairs + ctas - 1) / ctas;
  Args args{CA, CB, XA, YB, ea0, eb0, cfa, efa, cfb, efb, iprm, fprm,
            score.data(), dirs.data(), opens.data(), vals0, hdir0, runs0,
            valsf.data(), hdirf.data(), runsf.data(), span.data(),
            C, an, bn, an_max, bn_max, la_max, lb_max, nslot, nsteps, d0,
            ctas, pc};
  if (ls3)
    launch_emu<true>(args, B, variant, run_bytes, threads);
  else
    launch_emu<false>(args, B, variant, run_bytes, threads);
  FILE* o = fopen(argv[2], "wb");
  fwrite(score.data(), 4, B, o);
  fwrite(dirs.data(), 1, dirs.size(), o);
  fwrite(opens.data(), 1, opens.size(), o);
  fwrite(valsf.data(), 4, valsf.size(), o);
  fwrite(hdirf.data(), 1, hdirf.size(), o);
  fwrite(runsf.data(), 4, runsf.size(), o);
  fclose(o);
  for (void* p : taken) free(p);
  return 0;
}
"""

# the inline PTX and shared-memory declarations this script swaps
SWAPS = [
    ('asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");',
     "emu::ctx.phase = emu::ctx.cluster->arrive();"),
    ('asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");',
     "emu::ctx.cluster->wait(emu::ctx.phase);"),
    ("extern __shared__ float smem[];", "float* smem = emu::ctx.smem;"),
]

# broken copies of the source that the cases must catch: (old, new)
# replacements
MUTATIONS = {
    # the push of the edge slot into the neighbour's halo
    "no_push": [("copy_slot<LS3, GR>(S, R, NL, NLr, SRUNS, s0);", ";")],
    # the CTA barrier that orders the interior for the CTA's own threads
    "no_cta_barrier": [("    pf.mark(kSecInterior);\n    __syncthreads();",
                        "    pf.mark(kSecInterior);")],
    # the arrive before the edge: its push is not released by it
    "early_arrive": [
        ("    pf.mark(kSecEdge);\n    cluster_arrive();\n",
         "    pf.mark(kSecEdge);\n"),
        ("    if (qe >= 0 && t == (qe - q0) % T) {",
         "    cluster_arrive();\n    if (qe >= 0 && t == (qe - q0) % T) {")],
}


def source(src_dir: Path, mutate: str | None) -> str:
    text = (src_dir / "group_wavefront.cu").read_text()
    for old, new in MUTATIONS.get(mutate, []):
        if old not in text:
            raise ValueError(f"mutation {mutate}: no {old!r} in the source")
        text = text.replace(old, new, 1)
    start = text.index("namespace {")
    end = text.index("}  // namespace\n") + len("}  // namespace\n")
    body = text[start:end]
    for old, new in SWAPS:
        if old not in body:
            raise ValueError(f"no {old!r} in the kernel source")
        body = body.replace(old, new)
    if "asm" in re.sub(r"#ifdef K2_PROFILE.*?#endif", "", body, flags=re.S):
        raise ValueError("inline PTX left in the emulated source")
    return HEADER + body + DRIVER


def build(src_dir: Path, sanitize: str, mutate: str | None,
          out_dir: Path) -> Path:
    cpp = out_dir / f"k2_emu_{sanitize}_{mutate or 'ok'}.cpp"
    exe = cpp.with_suffix("")
    cpp.write_text(source(src_dir, mutate))
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-ffp-contract=off",
           f"-fsanitize={sanitize}", "-fno-omit-frame-pointer", "-pthread",
           "-o", str(exe), str(cpp)]
    subprocess.run(cmd, check=True)
    return exe


def dna_msa(arr, mtx, name="g"):
    m = Msa(codes=ab.encode("".join("ACGT"[c] for c in arr), ab.DNA)[None, :],
            molc=ab.DNA, names=[name])
    m.prepare(mtx.shape[0])
    return m


def prot_msa(rng, many, L, mtx):
    codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < 0.08] = ab.GAP
    codes[:, 0] = ab.ALA + rng.integers(0, 20)
    m = Msa(codes=codes, molc=ab.PROTEIN, names=[f"s{i}" for i in range(many)],
            weight=rng.random(many) + 0.5)
    m.prepare(mtx.shape[0])
    return m


def mutant(rng, base, sub=0.05):
    mut = list(base)
    p = int(rng.integers(10, len(mut) - 10))
    del mut[p:p + int(rng.integers(1, 4))]
    mut = np.array(mut)
    hit = rng.random(len(mut)) < sub
    mut[hit] = rng.integers(0, 4, int(hit.sum()))
    return mut


# name: (kind, pairs (members a side, lengths), pad, ls, variant, ctas,
# threads, start step, steps, the sh of the band)
CASES = {
    # one DNA pair over 3 CTAs, one live slot a thread
    "dna_p3": ("dna", [(1, 1, 150, 0)], 1, 1, "cluster", 3, 64, 0, None, -60),
    # and over 2 CTAs with two slot pairs a thread, from a carry
    "dna_p2_t8": ("dna", [(1, 1, 150, 0)], 1, 1, "cluster", 2, 8, 77, 64,
                  -60),
    # proteins, ls 3, 3 + 3 members, runs in shared memory, 3 CTAs
    "ls3_p3": ("prot", [(3, 3, 60, 0)], 3, 3, "cluster", 3, 16, 0, None,
               -60),
    # B's side padded to 32,768 - la_max columns, so a run could pass
    # int16: the runs as int32 in shared memory, 4 CTAs, from a carry
    "int32_p4": ("prot", [(9, 7, 50, 0)], 9, 1, "cluster", 4, 16, 33, 48,
                 -60),
    # and the same in device memory (the plan takes it past what shared
    # memory holds; asked for here)
    "device_p4": ("prot", [(9, 7, 50, 0)], 9, 1, "cluster", 4, 16, 33, 48,
                  -60),
    # a batch of three pairs, unequal bands and member counts
    "batch3": ("prot", [(1, 2, 40, 0), (3, 1, 55, 1), (2, 2, 47, 2)], 3, 1,
               "cluster", 3, 16, 0, None, -60),
    # k_end on a slice edge (a 2-CTA cluster over an odd band)
    "kend_p2": ("dna", [(1, 1, 96, 0)], 1, 1, "cluster", 2, 16, 0, None,
                -10),
    # the other variants through the shared per-slot step
    "shared": ("prot", [(3, 2, 50, 0)], 3, 3, "shared", 1, 32, 0, None, -60),
    "global": ("prot", [(3, 2, 50, 0)], 3, 1, "global", 1, 32, 41, 40, -60),
    "wide": ("dna", [(1, 1, 120, 0)], 1, 1, "wide", 1, 32, 0, None, -60),
}

# where a case asks the cluster variant to keep its runs
RUNS_ASKED = {"device_p4": "device"}


def case_inputs(name: str):
    kind, pairs, pad, ls, variant, ctas, threads, d0, n, sh = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind == "dna":
        mtx, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
        made = []
        for _, _, L, _ in pairs:
            base = rng.integers(0, 4, L)
            pair = (dna_msa(base, mtx), dna_msa(mutant(rng, base), mtx))
            # k_end on a slice edge needs the longer side as B
            made.append(pair[::-1] if name == "kend_p2" else pair)
        kw = dict(uniform=False)
    else:
        mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
        made = [(prot_msa(rng, a, L, mtx),
                 prot_msa(rng, b, L + int(rng.integers(-5, 6)), mtx))
                for a, b, L, _ in pairs]
        kw = dict(spb=20.0, ls=ls)
    la_max = lb_max = G._bucket(
        max(max(A.length, B.length) for A, B in made), 16)
    if name.endswith("_p4"):    # B padded: la_max + lb_max = 32,768
        lb_max = 32768 - la_max
    wd = [stripe(A.length, B.length, sh) for A, B in made]
    nslot = max(w.up - w.lw + 3 for w in wd)
    if name == "kend_p2":
        # k_end + 1 slot pairs (the last of one slot): k_end is the first
        # slice's last slot (odd) or the second's first (even)
        w = wd[0]
        k_end = (made[0][1].length - made[0][0].length) - (w.lw - 1)
        nslot = 2 * (k_end + 1) - 1
        assert nslot >= w.up - w.lw + 3, (nslot, w)
    nsteps_all = max(A.length + B.length + 1 for A, B in made)
    items = [G._pack_inputs(A, B, mtx, 2.0, 9.0, w, pad, pad, la_max, lb_max,
                            **kw) for (A, B), w in zip(made, wd)]
    ins = G.stack_inputs(items, "cpu")
    nsteps = n if n is not None else nsteps_all - d0
    return ins, dict(name=name, nslot=nslot, ls3=ls == 3, d0=d0,
                     nsteps=nsteps, variant=variant, ctas=ctas,
                     threads=threads)


def pack(path: Path, ins: dict, kw: dict, carry) -> dict:
    plan = G.wavefront_plan(ins, nslot=kw["nslot"], ls3=kw["ls3"],
                            variant=kw["variant"],
                            ctas=kw["ctas"] if kw["variant"] == "cluster"
                            else None)
    if kw["name"] in RUNS_ASKED:
        plan["runs"] = RUNS_ASKED[kw["name"]]
    XA, YB, CA, CB = G.kernel_operands(ins)
    Bn, la_max, C = ins["CA"].shape
    head = np.array([Bn, C, ins["wa"].shape[1], ins["wb"].shape[1],
                     plan["an_max"], plan["bn_max"], la_max,
                     ins["CB"].shape[1], kw["nslot"], kw["nsteps"], kw["d0"],
                     int(kw["ls3"]), G._K2_VARIANTS[plan["variant"]],
                     plan["ctas"], G.RUN_BYTES[plan["runs"]],
                     kw["threads"], int(carry is not None)], np.int32)
    iprm = torch.stack([ins[k] for k in G._IFIELDS]
                       + [plan["an_b"], plan["bn_b"]], 1)
    fprm = torch.stack([ins[k] for k in G._FFIELDS], 1)
    arrays = [CA, CB, XA, YB, *(ins[k] for k in ("ea0", "eb0", "cfa", "efa",
                                                 "cfb", "efb")), iprm, fprm]
    if carry is not None:
        arrays += list(carry)
    with path.open("wb") as f:
        f.write(head.tobytes())
        for a in arrays:
            f.write(a.contiguous().numpy().tobytes())
    return plan


def unpack(path: Path, ins: dict, kw: dict, plan: dict):
    Bn = ins["CA"].shape[0]
    nslot, nsteps = kw["nslot"], kw["nsteps"]
    rows = (5 if kw["ls3"] else 3) * (plan["an_max"] + plan["bn_max"])
    raw = path.read_bytes()
    at = 0

    def take(dtype, shape):
        nonlocal at
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out = torch.from_numpy(np.frombuffer(raw[at:at + n], dtype).reshape(
            shape).copy())
        at += n
        return out

    score = take(np.float32, (Bn,))
    dirs = take(np.int8, (Bn, nsteps, nslot))
    opens = take(np.int8, (Bn, nsteps, nslot))
    carry = G.Carry(take(np.float32, (Bn, 5, nslot)),
                    take(np.int8, (Bn, nslot)),
                    take(np.int32, (Bn, rows, nslot + 2)))
    return score, dirs, opens, carry


def run_case(exe: Path, name: str, tmp: Path) -> dict:
    ins, kw = case_inputs(name)
    carry = None
    if kw["d0"]:
        carry = G.group_wavefront_ref(ins, nslot=kw["nslot"], ls3=kw["ls3"],
                                      nsteps=kw["d0"])[3]
        plan = G.wavefront_plan(ins, nslot=kw["nslot"], ls3=kw["ls3"])
        rows = (5 if kw["ls3"] else 3) * (plan["an_max"] + plan["bn_max"])
        assert carry.runs.shape[1] == rows
    plan = pack(tmp / "in.bin", ins, kw, carry)
    res = subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")],
                         capture_output=True, text=True, timeout=1800)
    rec = {"case": name, "variant": plan["variant"], "ctas": plan["ctas"],
           "runs": plan["runs"], "nslot": kw["nslot"], "steps": kw["nsteps"],
           "d0": kw["d0"], "threads": kw["threads"],
           "slices": G.cluster_slices(kw["nslot"], plan["ctas"]),
           "rc": res.returncode}
    if res.returncode != 0:
        rec["stderr"] = res.stderr[-3000:]
        rec["equal"] = False
        return rec
    got = unpack(tmp / "out.bin", ins, kw, plan)
    ref = G.group_wavefront_ref(ins, nslot=kw["nslot"], ls3=kw["ls3"],
                                nsteps=kw["nsteps"], d0=kw["d0"], carry=carry)
    rec["score_equal"] = torch.equal(got[0].view(torch.int32),
                                     ref[0].view(torch.int32))
    rec["dirs_equal"] = torch.equal(got[1], ref[1])
    rec["opens_equal"] = torch.equal(got[2], ref[2])
    rec["carry_equal"] = G.carry_equal(got[3], ref[3])
    rec["equal"] = all(rec[k] for k in ("score_equal", "dirs_equal",
                                        "opens_equal", "carry_equal"))
    if "race" in res.stderr or "ERROR" in res.stderr:
        rec["stderr"] = res.stderr[-3000:]
        rec["equal"] = False
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=("address", "thread"),
                    default="address")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--src", type=Path,
                    default=REPO / "prrn_aln_tpu_torch" / "csrc")
    ap.add_argument("--mutate", choices=sorted(MUTATIONS))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    out_dir = REPO / "build" / "k2_emulate"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = build(args.src, args.sanitize, args.mutate, out_dir)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.cases.split(","):
            rec = run_case(exe, name, Path(tmp))
            rec.update(sanitize=args.sanitize, mutate=args.mutate)
            print(json.dumps(rec), flush=True)
            bad += not rec["equal"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
