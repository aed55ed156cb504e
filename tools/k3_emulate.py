#!/usr/bin/env python3
"""Rehearse kernel K3 (``csrc/traceback.cu``) on the CPU, every CUDA
thread a ``std::thread``, and hold its walks to the plain versions.

Run from the repository root (needs ``g++``; no card, no ``nvcc``):

    python3 tools/k3_emulate.py
    python3 tools/k3_emulate.py --cases k2_window,range_window --mutate early_release

The source's first anonymous namespace (the kernels and their device
helpers) is compiled with ``g++ -std=c++20 -fsanitize=address`` after a
header that defines the CUDA keywords, ``threadIdx``/``blockIdx``/
``blockDim`` as ``thread_local`` values, ``extern __shared__`` as one
buffer a block of exactly its bytes, the warp shuffles and
``__syncwarp`` as an exchange through an array a warp between two spin
barriers, and ``__syncthreads`` as a spin barrier on ``std::atomic``.
The PTX helpers are swapped for emulations: an mbarrier is its 8 bytes
of shared memory as one ``std::atomic_ref<uint64_t>`` (pending arrivals,
transaction bytes, phase), ``mbarrier.arrive``/``expect_tx`` and
``try_wait.parity`` act on it, and a copy (``cp.async.bulk``, or
``cp.async`` with ``cp.async.mbarrier.arrive.noinc``) fills its
destination with a poison byte when issued and is done by a copy engine
thread two milliseconds later, which then completes its bytes (or the
lane's arrival) on the barrier; so a read before the wait, or a buffer refilled while
the walker still reads it, shows as moves that differ, and a wait that
is never satisfied as a case that times out.

Each case walks seeded planes (random bytes, whose walks wander and
leave the band, or the planes ``group_wavefront_ref`` makes of a DNA
pair, whose walks keep near the diagonal) from the end and as range
walks from a middle step, in the variant and plan it names (the window
variant with small tiles, narrow windows and 2-4 stages, so that tiles
are crossed often and reads fall outside their windows; the staged and
global variants), and compares moves, counts and stop points with
``traceback_ref`` / ``traceback_range_ref``.  ``--mutate`` builds a
broken copy of the source to show that the cases catch it.  Prints one
JSON line a case and exits non-zero on any mismatch.
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
from prrn_aln_tpu_torch.config import default_params  # noqa: E402
from prrn_aln_tpu_torch.msa.msa import Msa  # noqa: E402
from prrn_aln_tpu_torch.ops import group as G  # noqa: E402
from prrn_aln_tpu_torch.ops.window import stripe  # noqa: E402

HEADER = r"""
#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __launch_bounds__(x)
#define __restrict__
#define __align__(x)
using std::max;
using std::min;
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
namespace emu {
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
struct Warp {
  Spin bar;
  long long word[32];
};
struct Ctx {
  dim3 tid, bid, bdim, gdim;
  unsigned char* smem;
  Spin* cta;
  Warp* warp;
};
thread_local Ctx ctx;
inline void syncthreads() { ctx.cta->wait(ctx.cta->arrive()); }
template <class T> T shfl(T v, int from) {
  Warp& w = *ctx.warp;
  const int lane = ctx.tid.x & 31;
  w.word[lane] = (long long)v;
  w.bar.wait(w.bar.arrive());
  const T r = from >= 0 && from < 32 ? (T)w.word[from] : v;
  w.bar.wait(w.bar.arrive());
  return r;
}
inline void syncwarp() { ctx.warp->bar.wait(ctx.warp->bar.arrive()); }
inline int any(int p) {
  Warp& w = *ctx.warp;
  w.word[ctx.tid.x & 31] = p != 0;
  w.bar.wait(w.bar.arrive());
  int r = 0;
  for (int l = 0; l < 32; ++l) r |= (int)w.word[l];
  w.bar.wait(w.bar.arrive());
  return r;
}

// an mbarrier: bits 0-31 transaction bytes (signed), 32-47 pending
// arrivals, 48-55 the arrival count, 56-63 completed phases
inline std::atomic_ref<uint64_t> mb(uint64_t* bar) {
  return std::atomic_ref<uint64_t>(*bar);
}
inline uint64_t mb_make(int tx, int pending, int count, int phase) {
  return (uint64_t)(uint32_t)tx | ((uint64_t)(pending & 0xffff) << 32) |
         ((uint64_t)(count & 0xff) << 48) | ((uint64_t)(phase & 0xff) << 56);
}
// add dtx transaction bytes and take darr arrivals; complete the phase
// where both reach 0
inline void mb_update(uint64_t* bar, int dtx, int darr) {
  auto a = mb(bar);
  uint64_t old = a.load(std::memory_order_acquire), nw;
  do {
    int tx = (int)(uint32_t)old + dtx;
    int pending = (int)((old >> 32) & 0xffff) - darr;
    const int count = (int)((old >> 48) & 0xff);
    int phase = (int)(old >> 56);
    if (pending < 0) { fprintf(stderr, "ERROR mbarrier over-arrived\n"); abort(); }
    if (pending == 0 && tx == 0) { ++phase; pending = count; }
    nw = mb_make(tx, pending, count, phase);
  } while (!a.compare_exchange_weak(old, nw, std::memory_order_acq_rel));
}
inline bool mb_done(uint64_t* bar, uint32_t parity) {
  const uint64_t v = mb(bar).load(std::memory_order_acquire);
  return ((v >> 56) & 1) != parity;
}

// the copy engine: copies done in order, a few microseconds after issue
struct Copy {
  void* dst;
  const void* src;
  uint32_t bytes;
  uint64_t* bar;
  std::chrono::steady_clock::time_point due;
  bool arrive;     // an arrival on bar once the copies before it landed
};
std::mutex qlock;
std::deque<Copy> queue;
std::atomic<bool> stop{false};
void engine() {
  for (;;) {
    Copy c;
    bool got = false;
    {
      std::lock_guard<std::mutex> hold(qlock);
      if (!queue.empty()) {
        c = queue.front();
        queue.pop_front();
        got = true;
      } else if (stop.load()) {
        return;
      }
    }
    if (!got) { std::this_thread::yield(); continue; }
    std::this_thread::sleep_until(c.due);
    if (c.arrive) {
      mb_update(c.bar, 0, 1);
      continue;
    }
    memcpy(c.dst, c.src, c.bytes);
    if (c.bar) mb_update(c.bar, -(int)c.bytes, 0);
  }
}
}  // namespace emu
#define threadIdx (emu::ctx.tid)
#define blockIdx (emu::ctx.bid)
#define blockDim (emu::ctx.bdim)
#define gridDim (emu::ctx.gdim)
#define __syncthreads() emu::syncthreads()
#define __syncwarp() emu::syncwarp()
#define __shfl_sync(m, v, l) emu::shfl((v), (l))
#define __shfl_xor_sync(m, v, d) emu::shfl((v), (int)(threadIdx.x & 31) ^ (d))
#define __any_sync(m, p) emu::any(p)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  emu::mb(bar).store(emu::mb_make(0, count, count, 0));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu::mb_update(bar, (int)bytes, 1);
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  const bool ok = emu::mb_done(bar, parity);
  if (!ok) std::this_thread::yield();
  return ok;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  emu::mb_update(bar, 0, 1);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  if (((uintptr_t)dst & 15) || ((uintptr_t)src & 15) || (bytes & 15)) {
    fprintf(stderr, "ERROR bulk copy not on 16 bytes\n");
    abort();
  }
  memset(dst, 0x5a, bytes);
  std::lock_guard<std::mutex> hold(emu::qlock);
  emu::queue.push_back({dst, src, bytes, bar,
                        std::chrono::steady_clock::now() +
                            std::chrono::milliseconds(2), false});
}
// cp.async: the copy queued with no barrier, its lane's arrival on one
// queued behind it (the queue lands in order)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  if (((uintptr_t)dst & 15) || ((uintptr_t)src & 15)) {
    fprintf(stderr, "ERROR cp.async not on 16 bytes\n");
    abort();
  }
  memset(dst, 0x5a, 16);
  std::lock_guard<std::mutex> hold(emu::qlock);
  emu::queue.push_back({dst, src, 16, nullptr,
                        std::chrono::steady_clock::now() +
                            std::chrono::milliseconds(2), false});
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> hold(emu::qlock);
  emu::queue.push_back({nullptr, nullptr, 0, bar,
                        std::chrono::steady_clock::now() +
                            std::chrono::milliseconds(2), true});
}
"""

DRIVER = r"""
namespace {
template <class K, class... A>
void run_blocks(K kernel, int grid, int threads, size_t smem, A... args) {
  std::thread eng(emu::engine);
  std::vector<unsigned char*> bufs(grid);
  std::vector<emu::Spin> ctas(grid);
  std::vector<emu::Warp> warps(grid * ((threads + 31) / 32));
  for (int r = 0; r < grid; ++r) {
    // 128-byte aligned, as the card places dynamic shared memory
    bufs[r] = (unsigned char*)aligned_alloc(128, (smem + 127) / 128 * 128 + 128);
    memset(bufs[r], 0xa5, smem);
    ctas[r].total = threads;
  }
  for (auto& w : warps) w.bar.total = 32;
  std::vector<std::thread> pool;
  for (int r = 0; r < grid; ++r)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, r, t] {
        emu::ctx.tid.x = t;
        emu::ctx.bid.x = r;
        emu::ctx.bdim.x = threads;
        emu::ctx.gdim.x = grid;
        emu::ctx.smem = bufs[r];
        emu::ctx.cta = &ctas[r];
        emu::ctx.warp = &warps[r * ((threads + 31) / 32) + t / 32];
        kernel(args...);
      });
  for (auto& th : pool) th.join();
  emu::stop = true;
  eng.join();
  {
    std::lock_guard<std::mutex> hold(emu::qlock);
    if (!emu::queue.empty()) {
      fprintf(stderr, "ERROR a copy still queued when the blocks exited\n");
      abort();
    }
  }
  for (auto* b : bufs) free(b);
}

std::vector<void*> taken;
template <class T>
T* take(FILE* f, size_t n) {
  T* p = (T*)aligned_alloc(16, (n * sizeof(T) + 16) / 16 * 16);
  taken.push_back(p);
  if (fread(p, sizeof(T), n, f) != n) { fprintf(stderr, "short input\n"); exit(2); }
  return p;
}
}  // namespace

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[10];
  if (fread(h, sizeof(int), 10, f) != 10) return 2;
  const int B = h[0], nsteps = h[1], nslot = h[2], max_iters = h[3],
            range = h[4], variant = h[5], T = h[6], width = h[7],
            stages = h[8], smem_bytes = h[9];
  auto* dirs = take<int8_t>(f, (size_t)B * nsteps * nslot);
  auto* opens = take<int8_t>(f, (size_t)B * nsteps * nslot);
  auto* m0 = take<int32_t>(f, B);
  auto* n0 = take<int32_t>(f, B);
  auto* lane0 = take<int32_t>(f, B);
  auto* d_lo = take<int32_t>(f, B);
  auto* lw = take<int32_t>(f, B);
  fclose(f);
  std::vector<int8_t> moves((size_t)B * max_iters, 77);
  std::vector<int32_t> cnts(B, -9), mf(B, -9), nf(B, -9), lanef(B, -9);
  const Walk w{m0, n0, range ? lane0 : nullptr, range ? d_lo : nullptr, lw,
               moves.data(), cnts.data(), mf.data(), nf.data(), lanef.data(),
               range};
  if (variant == 2)
    run_blocks(traceback_window_kernel, B, kWinThreads, (size_t)smem_bytes,
               (const int8_t*)dirs, (const int8_t*)opens, w, nsteps, nslot,
               max_iters, T, width, stages);
  else if (variant == 1)
    run_blocks(traceback_staged_kernel, B, kThreads, (size_t)smem_bytes,
               (const int8_t*)dirs, (const int8_t*)opens, w, nsteps, nslot,
               max_iters, T, width);
  else {
    emu::ctx.bdim.x = 1;
    for (int b = 0; b < B; ++b) {
      emu::ctx.bid.x = 0;
      emu::ctx.tid.x = b;
      traceback_global_kernel((const int8_t*)dirs, (const int8_t*)opens, w,
                              B, nsteps, nslot, max_iters);
    }
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(moves.data(), 1, moves.size(), o);
  fwrite(cnts.data(), 4, B, o);
  fwrite(mf.data(), 4, B, o);
  fwrite(nf.data(), 4, B, o);
  fwrite(lanef.data(), 4, B, o);
  fclose(o);
  for (void* p : taken) free(p);
  return 0;
}
"""

# the PTX helpers the header emulates: their definitions are taken out
HELPERS = [r"__device__ __forceinline__ uint32_t smem_u32\(.*?\n}\n",
           r"__device__ __forceinline__ void mbar_init\(.*?\n}\n",
           r"__device__ __forceinline__ void mbar_expect_tx\(.*?\n}\n",
           r"__device__ __forceinline__ bool mbar_try_wait\(.*?\n}\n",
           r"__device__ __forceinline__ void mbar_wait\(.*?\n}\n",
           r"__device__ __forceinline__ void bulk_g2s\(.*?\n}\n",
           r"__device__ __forceinline__ void mbar_arrive\(.*?\n}\n",
           r"__device__ __forceinline__ void cp_async16\(.*?\n}\n",
           r"__device__ __forceinline__ void cp_async_arrive\(.*?\n}\n"]
SWAPS = [
    ('asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");',
     ";"),
    ('asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', ";"),
    ("extern __shared__ __align__(128) unsigned char smem[];",
     "unsigned char* smem = emu::ctx.smem;"),
]

# broken copies of the source that the cases must catch: (old, new)
MUTATIONS = {
    # the walker releases a stage before it leaves it
    "early_release": [("          if (cur >= 0) {\n            hint[cur % NS] = slot;\n"
                       "            mbar_arrive(&empty[cur % NS]);\n          }\n"
                       "          ++cur;\n          const int s = cur % NS;\n"
                       "          mbar_wait(&full[s], (cur / NS) & 1);",
                       "          ++cur;\n          const int s = cur % NS;\n"
                       "          mbar_arrive(&empty[s]);\n"
                       "          mbar_wait(&full[s], (cur / NS) & 1);")],
    # the walker does not wait for its tile's copies
    "no_wait": [("          mbar_wait(&full[s], (cur / NS) & 1);\n          r1c",
                 "          r1c")],
    # a row's window one row off in the buffer
    "row_off": [("const int i = (r1c - row) * Wd + at;",
                 "const int i = (r1c - row + 1) * Wd + at;")],
    # a whole tile's window one 16-byte step off
    "whole_off": [("int at = slot - (c0c & ~15);",
                   "int at = slot - (c0c & ~15) + 16;")],
}


def source(src_dir: Path, mutate: str | None) -> str:
    text = (src_dir / "traceback.cu").read_text()
    for old, new in MUTATIONS.get(mutate, []):
        if old not in text:
            raise ValueError(f"mutation {mutate}: no {old!r} in the source")
        text = text.replace(old, new, 1)
    start = text.index("namespace {")
    end = text.index("}  // namespace\n") + len("}  // namespace\n")
    body = text[start:end]
    for pat in HELPERS:
        body, n = re.subn(pat, "", body, count=1, flags=re.S)
        if n != 1:
            raise ValueError(f"no {pat!r} in the kernel source")
    for old, new in SWAPS:
        if old not in body:
            raise ValueError(f"no {old!r} in the kernel source")
        body = body.replace(old, new)
    if "asm" in body:
        raise ValueError("inline PTX left in the emulated source")
    return HEADER + body + DRIVER


def build(src_dir: Path, mutate: str | None, out_dir: Path) -> Path:
    cpp = out_dir / f"k3_emu_{mutate or 'ok'}.cpp"
    exe = cpp.with_suffix("")
    cpp.write_text(source(src_dir, mutate))
    cmd = ["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address",
           "-fno-omit-frame-pointer", "-pthread", "-o", str(exe), str(cpp)]
    subprocess.run(cmd, check=True)
    return exe


def k2_planes(name: str, L: int, sh: int, bucket: bool = False):
    """The planes K2's plain version makes of a seeded DNA pair (its
    slots rounded up to 128, as the aligners bucket them, where
    ``bucket``)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    mtx, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))

    def msa(arr):
        m = Msa(codes=ab.encode("".join("ACGT"[c] for c in arr),
                                ab.DNA)[None, :], molc=ab.DNA, names=["g"])
        m.prepare(mtx.shape[0])
        return m

    base = rng.integers(0, 4, L)
    mut = list(base)
    for _ in range(3):
        p = int(rng.integers(10, len(mut) - 10))
        if rng.random() < 0.5:
            del mut[p:p + int(rng.integers(1, 4))]
        else:
            mut[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
    mut = np.array(mut)
    hit = rng.random(len(mut)) < 0.08
    mut[hit] = rng.integers(0, 4, int(hit.sum()))
    A, B = msa(base), msa(mut)
    w = stripe(A.length, B.length, sh)
    nslot = w.up - w.lw + 3
    if bucket:
        nslot = G._bucket(nslot, 128)
    ins = G.stack_inputs([G._pack_inputs(A, B, mtx, 2.0, 9.0, w, 1, 1,
                                         A.length, B.length, uniform=False)],
                         "cpu")
    nsteps = A.length + B.length + 1
    _, dirs, opens, _ = G.group_wavefront_ref(ins, nslot=nslot, nsteps=nsteps)
    return dirs, opens, ins["la"], ins["lb"], ins["lw"]


def random_planes(name: str, Bn: int, nsteps: int, nslot: int):
    rng = np.random.default_rng(sum(map(ord, name)))
    # mostly diagonal sources, some gap sources and open bits
    src = rng.choice(5, size=(Bn, nsteps, nslot), p=[0.7, 0.1, 0.1, 0.05,
                                                     0.05]).astype(np.int8)
    ops = rng.integers(0, 16, size=(Bn, nsteps, nslot)).astype(np.int8)
    m0 = rng.integers(nsteps // 4, nsteps // 2, Bn).astype(np.int32)
    n0 = (nsteps - 1 - m0 - rng.integers(0, 3, Bn)).astype(np.int32)
    lw = (-rng.integers(nslot // 3, nslot // 2, Bn)).astype(np.int32)
    t = torch.as_tensor
    return t(src), t(ops), t(m0), t(n0), t(lw)


# name: (planes, range walk (d_lo) or None, the plan asked for)
CASES = {
    "k2_window": ("k2:300:-60", None,
                  dict(variant="window", tile_rows=4, width=32, stages=2)),
    "k2_window_wide": ("k2:300:-60", None, dict(variant="window")),
    # rows of a multiple of 16 slots: the whole tiles' index
    "k2b_window": ("k2b:300:-60", None,
                   dict(variant="window", tile_rows=4, width=32, stages=2)),
    "k2b_window_wide": ("k2b:300:-60", None, dict(variant="window")),
    "rand96_window": ("rand:3:700:96", None,
                      dict(variant="window", tile_rows=5, width=48,
                           stages=3)),
    "k2b_range_window": ("k2b:300:-60", 301,
                         dict(variant="window", tile_rows=4, width=32,
                              stages=3)),
    "k2_window_s4": ("k2:200:-30", None,
                     dict(variant="window", tile_rows=3, width=16, stages=4)),
    "rand_window": ("rand:3:700:90", None,
                    dict(variant="window", tile_rows=5, width=48, stages=3)),
    "range_window": ("k2:300:-60", 301,
                     dict(variant="window", tile_rows=4, width=32,
                          stages=3)),
    "rand_range_window": ("rand:2:600:70", 255,
                          dict(variant="window", tile_rows=2, width=16,
                               stages=2)),
    "k2_staged": ("k2:300:-60", None, dict(variant="staged", tile_rows=8)),
    "k2_global": ("k2:300:-60", None, dict(variant="global")),
}


def case_inputs(name: str):
    spec, d_lo, ask = CASES[name]
    kind, *nums = spec.split(":")
    if kind in ("k2", "k2b"):
        dirs, opens, La, Lb, lw = k2_planes(name, int(nums[0]), int(nums[1]),
                                            kind == "k2b")
        m0, n0 = La.clone(), Lb.clone()
    else:
        dirs, opens, m0, n0, lw = random_planes(name, *map(int, nums))
    Bn, nsteps, nslot = dirs.shape
    max_iters = 2 * (nsteps + 2) + 4
    if d_lo is None:
        return dirs, opens, (m0, n0, lw), None, max_iters, ask
    # a range walk over the rows from d_lo on, from a point on the path
    # above them (the plain walk's position after its first moves)
    steps = nsteps - d_lo
    sub_d = dirs[:, d_lo:].contiguous()
    sub_o = opens[:, d_lo:].contiguous()
    lane0 = torch.zeros_like(m0)
    top = torch.full_like(m0, d_lo) + steps - 1
    m_start = torch.minimum(m0, top // 2)
    n_start = torch.minimum(n0, top - m_start)
    return (sub_d, sub_o, (m_start, n_start, lw),
            (lane0, torch.full_like(m0, d_lo)), max_iters, ask)


def run_case(exe: Path, name: str, tmp: Path) -> dict:
    dirs, opens, (m0, n0, lw), rng_args, max_iters, ask = case_inputs(name)
    Bn, nsteps, nslot = dirs.shape
    plan = G.traceback_plan(nsteps, nslot, max_iters, **ask)
    code = G._K3_VARIANTS[plan["variant"]]
    rng_on = rng_args is not None
    lane0, d_lo = rng_args if rng_on else (torch.zeros_like(m0),) * 2
    head = np.array([Bn, nsteps, nslot, max_iters, int(rng_on), code,
                     plan["tile_rows"], plan["width"], plan.get("stages", 0),
                     plan["smem_bytes"]], np.int32)
    with (tmp / "in.bin").open("wb") as f:
        f.write(head.tobytes())
        for x in (dirs, opens, m0, n0, lane0, d_lo, lw):
            f.write(x.to(x.dtype).contiguous().numpy().tobytes())
    rec = {"case": name, **plan, "pairs": Bn, "nsteps": nsteps,
           "nslot": nslot}
    try:
        res = subprocess.run([str(exe), str(tmp / "in.bin"),
                              str(tmp / "out.bin")], capture_output=True,
                             text=True, timeout=600)
    except subprocess.TimeoutExpired:
        rec.update(equal=False, stderr="timed out (a wait never satisfied)")
        return rec
    rec["rc"] = res.returncode
    if res.returncode != 0:
        rec.update(equal=False, stderr=res.stderr[-3000:])
        return rec
    raw = (tmp / "out.bin").read_bytes()
    moves = torch.from_numpy(np.frombuffer(raw[:Bn * max_iters], np.int8)
                             .reshape(Bn, max_iters).copy())
    ints = np.frombuffer(raw[Bn * max_iters:], np.int32).reshape(4, Bn)
    if rng_on:
        want = G.traceback_range_ref(dirs, opens, m0, n0, lane0, d_lo, lw,
                                     max_iters=max_iters)
        got = (*(torch.as_tensor(ints[k].copy()) for k in (1, 2, 3)), moves,
               torch.as_tensor(ints[0].copy()))
    else:
        want = G.traceback_ref(dirs, opens, m0, n0, lw, max_iters=max_iters)
        got = (moves, torch.as_tensor(ints[0].copy()))
    rec["moves"] = int(want[-1].sum())
    rec["equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    if "ERROR" in res.stderr:
        rec.update(equal=False, stderr=res.stderr[-3000:])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--src", type=Path,
                    default=REPO / "prrn_aln_tpu_torch" / "csrc")
    ap.add_argument("--mutate", choices=sorted(MUTATIONS))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    out_dir = REPO / "build" / "k3_emulate"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = build(args.src, args.mutate, out_dir)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.cases.split(","):
            rec = run_case(exe, name, Path(tmp))
            rec.update(mutate=args.mutate)
            print(json.dumps(rec), flush=True)
            bad += not rec["equal"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
