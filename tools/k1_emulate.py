#!/usr/bin/env python3
"""Rehearse kernel K1 (``csrc/pairwise.cu``) on the CPU, every CUDA
thread a ``std::thread``, and hold it bit for bit to its plain version.

Run from the repository root (needs ``g++``; no card, no ``nvcc``):

    python3 tools/k1_emulate.py                   # AddressSanitizer
    python3 tools/k1_emulate.py --sanitize thread # ThreadSanitizer
    python3 tools/k1_emulate.py --mutate no_push --cases dna_p2

The source's anonymous namespace (the kernels and their device helpers)
is compiled with ``g++ -std=c++17 -ffp-contract=off`` after a header
that defines the CUDA keywords, ``threadIdx``/``blockIdx``/``blockDim``
as ``thread_local`` values, ``extern __shared__`` as one buffer a CTA of
exactly its bytes, the warp
shuffles as an exchange through an array a warp between two spin
barriers, and ``__syncthreads``, the named barrier and the split cluster
barrier (``barrier.cluster.arrive.release`` / ``wait.acquire``, swapped
in for the inline PTX by this script) as spin barriers on
``std::atomic`` alone (as ``tools/k2_emulate.py`` does, and for the same
reason: ``std::barrier``'s hashed mutexes would give ThreadSanitizer a
happens-before that hides a missing wait).  ``cg::this_cluster()``'s
``map_shared_rank`` returns the same offset in another CTA's buffer.  A
cluster's CTAs and threads run at once and really race between
barriers, so a missing barrier or push shows as a score that differs or
as a report of a race.

Each case scores seeded DNA or protein pairs (the stripe of ``sh``) in
the variant and plan it names (the cluster variant at 2-4 CTAs, with the
default exchange period and with an exchange every step, global and
local scores, a band edge on a CTA's edge, a batch of unequal pairs; the
warps variant; the block variant with its band in shared and in device
memory) and compares the scores with ``wavefront_scores_ref`` bit for
bit.  ``--mutate`` builds a broken copy of the source (a push or a
barrier taken out) to show that the cases catch it.  Prints one JSON
line a case and exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
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
from prrn_aln_tpu_torch.ops import pairwise as P  # noqa: E402
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
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
using std::max;
using std::min;
struct dim3 { unsigned x = 1, y = 1, z = 1; };
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
// a warp: its barrier and the words its shuffles pass
struct Warp {
  Spin bar;
  float word[32];
};
struct Ctx {
  dim3 tid, bid, bdim;
  unsigned char* smem;
  unsigned char** cluster_smem;
  Spin *cta, *cluster;
  Warp* warp;
  int rank, nblocks, phase;
};
thread_local Ctx ctx;
inline void syncthreads() { ctx.cta->wait(ctx.cta->arrive()); }
// lane ``from``'s value (its own where ``from`` is out of the warp)
inline float shfl(float v, int from) {
  Warp& w = *ctx.warp;
  const int lane = ctx.tid.x & 31;
  w.word[lane] = v;
  w.bar.wait(w.bar.arrive());
  const float r = from >= 0 && from < 32 ? w.word[from] : v;
  w.bar.wait(w.bar.arrive());
  return r;
}
}  // namespace emu
#define threadIdx (emu::ctx.tid)
#define blockIdx (emu::ctx.bid)
#define blockDim (emu::ctx.bdim)
#define __syncthreads() emu::syncthreads()
#define __shfl_up_sync(m, v, d) emu::shfl((v), (int)(threadIdx.x & 31) - (d))
#define __shfl_down_sync(m, v, d) emu::shfl((v), (int)(threadIdx.x & 31) + (d))
#define __shfl_xor_sync(m, v, d) emu::shfl((v), (int)(threadIdx.x & 31) ^ (d))
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::ctx.rank; }
  unsigned num_blocks() const { return emu::ctx.nblocks; }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    return reinterpret_cast<T*>(
        emu::ctx.cluster_smem[r] +
        (reinterpret_cast<unsigned char*>(p) - emu::ctx.smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

# the launch loop and the input reader (tools/k1f_emulate.py uses them too)
RUNNER = r"""
#ifndef EMU_POISON
#define EMU_POISON 0xa5
#endif
namespace {
// launch ``kernel`` over ``grid`` blocks, ``per_cluster`` at once (a
// cluster's CTAs and threads together), ``threads`` a block
template <class K, class... A>
void run_blocks(K kernel, int grid, int per_cluster, int threads,
                size_t smem, A... args) {
  for (int c0 = 0; c0 < grid; c0 += per_cluster) {
    std::vector<unsigned char*> bufs(per_cluster);
    std::vector<emu::Spin> ctas(per_cluster);
    std::vector<emu::Warp> warps(per_cluster * (threads / 32));
    emu::Spin cluster;
    cluster.total = per_cluster * threads;
    for (int r = 0; r < per_cluster; ++r) {
      bufs[r] = (unsigned char*)malloc(smem ? smem : 1);
      // poison: a read before a write shows
      memset(bufs[r], EMU_POISON, smem);
      ctas[r].total = threads;
    }
    for (auto& w : warps) w.bar.total = 32;
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
          emu::ctx.warp = &warps[r * (threads / 32) + t / 32];
          emu::ctx.rank = r;
          emu::ctx.nblocks = per_cluster;
          kernel(args...);
        });
    for (auto& th : pool) th.join();
    for (auto* b : bufs) free(b);
  }
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
"""

DRIVER = r"""
// argv[1]: the packed inputs (python side: ``pack``); argv[2]: scores
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[14];
  if (fread(h, sizeof(int), 14, f) != 14) return 2;
  const int B = h[0], Ma = h[1], Mb = h[2], dim = h[3], local = h[4],
            maxw = h[5], variant = h[6], lanes = h[7], threads = h[8],
            code_stride = h[9], smem_bytes = h[10], ctas = h[11],
            ghost = h[12], every = h[13];
  auto* a = take<int32_t>(f, (size_t)B * Ma);
  auto* b = take<int32_t>(f, (size_t)B * Mb);
  auto* la = take<int32_t>(f, B);
  auto* lb = take<int32_t>(f, B);
  auto* lw = take<int32_t>(f, B);
  auto* up = take<int32_t>(f, B);
  auto* u = take<float>(f, B);
  auto* v = take<float>(f, B);
  auto* tg = take<float>(f, B);
  auto* exg = take<uint8_t>(f, (size_t)B * 4);
  auto* mtx = take<float>(f, (size_t)dim * dim);
  fclose(f);
  std::vector<float> out(B, 7.0f);
  if (variant == 0 || variant == 4) {
    // the block variant: band in shared memory, or (4) in device memory
    std::vector<float> state((size_t)B * 3 * maxw, 5.0f);
    if (variant == 0)
      run_blocks(pairwise_block_kernel<false>, B, 1, kBlockThreads,
                 (size_t)smem_bytes, a, b, la, lb, lw, up, u, v, tg, exg,
                 mtx, out.data(), Ma, Mb, dim, local, maxw, (float*)nullptr,
                 1);
    else
      run_blocks(pairwise_block_kernel<true>, B, 1, kBlockThreads,
                 (size_t)smem_bytes, a, b, la, lb, lw, up, u, v, tg, exg,
                 mtx, out.data(), Ma, Mb, dim, local, maxw, state.data(),
                 (int)((size_t)smem_bytes >= 4 * ((size_t)dim * dim + 32)));
  } else {
    const RegKernel kern = pick_kernel(variant, lanes, local);
    if (kern == nullptr) return 3;
    const Ghost gh{ctas, ghost, every, 2 * lanes * (threads - 2 * ghost)};
    const int per = variant == 3 ? ctas : 1;
    const int grid = variant == 3 ? B * ctas
                     : variant == 1 ? (B + threads / 32 - 1) / (threads / 32)
                                    : B;
    run_blocks(kern, grid, per, threads, (size_t)smem_bytes, a, b, la, lb,
               lw, up, u, v, tg, exg, mtx, out.data(), B, Ma, Mb, dim, maxw,
               code_stride, gh);
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, B, o);
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
    ('asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");',
     "(void)nthreads; emu::syncthreads();"),
    ("extern __shared__ __align__(16) unsigned char smem[];",
     "unsigned char* smem = emu::ctx.smem;"),
]

# broken copies of the source that the cases must catch: (old, new)
MUTATIONS = {
    # the push of the owned low edge into the lower neighbour's ghost
    "no_push": [("        if (push_low)\n          band_put<L>",
                 "        if (false)\n          band_put<L>")],
    # the cluster barrier of an exchange
    "no_barrier": [("        cluster_arrive();\n        cluster_wait();\n"
                    "        if (low_ghost)",
                    "        if (low_ghost)")],
    # the ghost buffers not alternated: a push can land on one a
    # neighbour still reads
    "one_buffer": [("float* gb = ghost + 12 * L * gL * (exch & 1);",
                    "float* gb = ghost;")],
}


def source(src_dir: Path, mutate: str | None) -> str:
    text = (src_dir / "pairwise.cu").read_text()
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
    if "asm" in body:
        raise ValueError("inline PTX left in the emulated source")
    return HEADER + body + RUNNER + DRIVER


def build(src_dir: Path, sanitize: str, mutate: str | None,
          out_dir: Path) -> Path:
    cpp = out_dir / f"k1_emu_{sanitize}_{mutate or 'ok'}.cpp"
    exe = cpp.with_suffix("")
    cpp.write_text(source(src_dir, mutate))
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-ffp-contract=off",
           f"-fsanitize={sanitize}", "-fno-omit-frame-pointer", "-pthread",
           "-o", str(exe), str(cpp)]
    subprocess.run(cmd, check=True)
    return exe


def mutant(rng, base, sub=0.05):
    mut = list(base)
    p = int(rng.integers(10, len(mut) - 10))
    del mut[p:p + int(rng.integers(1, 4))]
    mut = np.array(mut)
    hit = rng.random(len(mut)) < sub
    mut[hit] = rng.integers(0, 4, int(hit.sum()))
    return mut


# name: (kind, lengths of the pairs' first sequences, sh, local, the plan
# asked for)
CASES = {
    # one DNA pair over 2 CTAs of 2 warps, one slot pair a lane
    "dna_p2": ("dna", [150], -60, False,
               dict(variant="cluster", ctas=2, lanes=1, warps=2)),
    # the same with an exchange every step
    "dna_p2_g1": ("dna", [150], -60, False,
                  dict(variant="cluster", ctas=2, lanes=1, warps=2,
                       every=1)),
    # 3 CTAs of one warp, 2 slot pairs a lane and 2 ghost lanes, local
    "dna_p3_local": ("dna", [200], -60, True,
                     dict(variant="cluster", ctas=3, lanes=2, warps=1,
                          ghost=2)),
    # proteins over 4 CTAs, 3 slot pairs a lane, an exchange every 5
    "prot_p4": ("prot", [300], -60, False,
                dict(variant="cluster", ctas=4, lanes=3, warps=1, ghost=2,
                     every=5)),
    # a batch of three unequal pairs over 3 CTAs
    "batch3": ("dna", [70, 140, 101], -60, False,
               dict(variant="cluster", ctas=3, lanes=1, warps=2)),
    # the band's last slot on CTA 0's last owned slot (a band edge on a
    # CTA edge)
    "edge_p2": ("dna", [None], -60, False,
                dict(variant="cluster", ctas=2, lanes=1, warps=2)),
    # the warps variant through the same kernel
    "warps": ("prot", [90], -60, False,
              dict(variant="warps", lanes=1, warps=4)),
    # the block variant, its band in shared and in device memory (and the
    # matrix there too)
    "block": ("dna", [80], -60, False, dict(variant="block")),
    "block_device": ("dna", [80], -60, True,
                     dict(variant="block", state="device")),
    "block_device_gmtx": ("prot", [60], -60, False,
                          dict(variant="block", state="device")),
}


def case_inputs(name: str):
    kind, lengths, sh, local, ask = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind == "dna":
        mtx, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
        alph = 4
    else:
        mtx, _ = scoring.protein_matrix(AlnParams(pam=150))
        alph = 20
    pairs = []
    for L in lengths:
        if L is None:
            # the band's last slot in it (up) CTA 0's last owned slot, its
            # sentinel (up + 1) CTA 1's first
            owned = P.cluster_owned(ask["lanes"], ask["warps"],
                                    P._ghost_lanes(ask["lanes"]))
            L, dl = next((n, k) for n in range(20, 400) for k in range(3)
                         if stripe(n, n - k, sh).width == owned + 1)
            a = rng.integers(0, alph, L)
            b = np.resize(mutant(rng, a), L - dl)
        else:
            a = rng.integers(0, alph, L)
            b = mutant(rng, a) if kind == "dna" else rng.integers(
                0, alph, L + int(rng.integers(-5, 6)))
        off = 0 if kind == "dna" else 3
        pairs.append((a + off, b + off))
    if kind == "dna":   # DNA codes as the alphabet encodes them
        pairs = [tuple(ab.encode("".join("ACGT"[c] for c in x), ab.DNA)
                       .astype(np.int64) for x in pr) for pr in pairs]
    Bn = len(pairs)
    Ma = max(len(a) for a, _ in pairs)
    Mb = max(len(b) for _, b in pairs)
    A = np.zeros((Bn, Ma), np.int32)
    Bm = np.zeros((Bn, Mb), np.int32)
    for i, (a, b) in enumerate(pairs):
        A[i, :len(a)] = a
        Bm[i, :len(b)] = b
    wd = [stripe(len(a), len(b), sh) for a, b in pairs]
    t = torch.as_tensor
    args = (t(A), t(Bm), t(np.array([len(a) for a, _ in pairs], np.int32)),
            t(np.array([len(b) for _, b in pairs], np.int32)),
            t(np.array([w.lw for w in wd], np.int32)),
            t(np.array([w.up for w in wd], np.int32)),
            t(mtx.astype(np.float32)),
            t(np.full(Bn, 2.0, np.float32)), t(np.full(Bn, 9.0, np.float32)),
            t(np.full(Bn, 1.0, np.float32)),
            t(rng.random((Bn, 4)) < 0.25))
    return args, local, ask


def pack(path: Path, args, local: bool, ask: dict) -> dict:
    a, b, la, lb, lw, up, mtx, u, v, tg, exg = args
    maxw = int((up - lw).max()) + 3
    plan = P.pairwise_plan(maxw, a.shape[0], mtx.shape[0], a.shape[1],
                           b.shape[1], **ask)
    if ask.get("state") == "device" and mtx.shape[0] > 20:
        plan["smem_bytes"] = 128     # the matrix in device memory as well
    code = 4 if plan["state"] == "device" else P._K1_VARIANTS[plan["variant"]]
    head = np.array([a.shape[0], a.shape[1], b.shape[1], mtx.shape[0],
                     int(local), maxw, code, plan["lanes"], plan["threads"],
                     plan["code_stride"], plan["smem_bytes"], plan["ctas"],
                     plan["ghost"], plan["every"]], np.int32)
    with path.open("wb") as f:
        f.write(head.tobytes())
        for x in (a, b, la, lb, lw, up, u, v, tg):
            f.write(x.contiguous().numpy().tobytes())
        f.write(exg.to(torch.uint8).numpy().tobytes())
        f.write(mtx.contiguous().numpy().tobytes())
    return plan


def run_case(exe: Path, name: str, tmp: Path) -> dict:
    args, local, ask = case_inputs(name)
    plan = pack(tmp / "in.bin", args, local, ask)
    res = subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")],
                         capture_output=True, text=True, timeout=1800)
    rec = {"case": name, "local": local,
           **{k: plan[k] for k in ("variant", "lanes", "warps", "ctas",
                                   "slots_per_cta", "ghost", "every",
                                   "state", "smem_bytes")},
           "maxw": int((args[5] - args[4]).max()) + 3, "rc": res.returncode}
    if res.returncode != 0:
        rec["stderr"] = res.stderr[-3000:]
        rec["equal"] = False
        return rec
    got = torch.from_numpy(np.frombuffer((tmp / "out.bin").read_bytes(),
                                         np.float32).copy())
    ref = P._plain_pairwise(*args, local)
    rec["equal"] = torch.equal(got.view(torch.int32), ref.view(torch.int32))
    rec["scores"] = got.tolist()
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
    out_dir = REPO / "build" / "k1_emulate"
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
