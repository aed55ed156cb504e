// Kernel K3: traceback walk over the group wavefront's direction planes.
//
// Replaces prrn_aln_tpu/ops/group.py::_traceback_device (a lax.while_loop
// on the TPU, vmapped by traceback_batch).  Its plain version is
// ops/group.py::traceback_ref, which walks the same lane machine on the
// host; both emit the same moves, end to start, and the same count.
//
// What bounds it on the card: one dependent chain of La + Lb to
// 3 * max_iters steps per pair, each a two-byte read of the dirs/opens
// planes at an address that depends on the previous read: latency, not
// bandwidth.  Read from device memory (L2, where K2 left the planes) a
// step costs one L2 round trip, ~300 cycles.
//
// What the design does about it ("staged" variant): the walk only moves
// to lower anti-diagonals d = m + n (a diagonal move lowers d by 2, a gap
// move by 1, a lane switch keeps it), so the rows it reads next are known
// ahead: the next lower ones.  One thread block walks one pair.  Its
// walker thread stages tiles of T full band rows of both planes in shared
// memory, two tiles in flight: entering tile j it issues the bulk
// asynchronous copy (cp.async.bulk, completing on an mbarrier) of tile
// j + 1 into the buffer tile j - 1 left, and crossing into tile j + 1 it
// waits on that tile's barrier.  A step then reads shared memory.  With
// one thread walking, a step is a chain of dependent instructions, so the
// step keeps it short: the index is one multiply-add from (d, slot), the
// lane machine has no branches, and a tile that holds its rows whole
// needs no bounds test.
//
// A bulk copy needs 16-byte aligned addresses and sizes: each tile's
// window is rounded out to 16 bytes and clipped to the planes'
// allocation; in a tile so clipped (only at a misaligned end of the
// allocation) a read outside the window goes to device memory.  The
// moves are kept in shared memory during the walk; the block fills them
// with -1 and writes them out together.
//
// The "window" variant serves the bands whose tiles of 8 full rows do
// not fit in shared memory (ops/group.py::traceback_plan chooses by
// size): a move changes the band slot off + n - m by at most one a row
// (a diagonal move keeps it and drops two rows, a gap move drops one and
// shifts it by one), so the rows the walk reads next lie near the slot it
// stands on.  A tile is T rows of a window of Wd bytes of each plane,
// centred on the slot where the walk stood when the tile was asked for,
// in a ring of NS stages.  A second warp copies it in 16-byte pieces
// (cp.async, each lane's arriving on the tile's "full" mbarrier when
// they land), so the walker does not wait on the issue.  (With one bulk
// copy, cp.async.bulk, a row each tile crossing waited ~0.9 us for the
// tile's 2T copies: tools/k1k3_bench.py on an H100.)  Leaving a tile, the
// walker leaves its slot for the copier and arrives on the stage's
// "empty" mbarrier, and the copier, waiting on it, fetches the tile NS
// further into that stage.  A read outside its row's window (a walk that
// drifted further, or a clipped window at the allocation's ends) goes to
// device memory.  The moves go to device memory as the walk makes them
// (a store it does not wait for), and the two warps fill the rest with
// -1 after the walk, so neither the band's width nor the walk's length
// bounds the plan.
//
// The "global" variant, one thread a pair walking the planes in device
// memory (the earlier design), runs only when asked for.
//
// The range walk (replaces prrn_aln_tpu/ops/group.py::
// _traceback_device_range, the backward pass of the linear-space aligner;
// plain version ops/group.py::traceback_range_ref) is the same machine
// in both variants: it starts at a given (m, n, lane) on planes whose row
// i holds step d_lo + i, stops once m + n falls below max(d_lo, 1), and
// returns where it stopped.  The walk from the end is the range walk with
// d_lo = 0, lane 0 and no floor.  The staged variant's first tile starts
// at the walk's first row, m0 + n0 - d_lo, and its last ends at the
// lowest row a step can read (row 0 where d_lo >= 1).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int8_t L_DIAG = 0, L_VERT = 1, L_HORI = 2, L_VERT2 = 3,
                 L_HORI2 = 4;
constexpr int kThreads = 128;
// shared memory ahead of the tile buffers: two mbarriers, padded
constexpr int kHead = 128;

// One step of the lane machine (group.py:705-739), without branches:
// src/op are the planes' bytes at (d, slot), or -1/0 outside the planes.
// From H (state 0) a DIAG source moves diagonally, any other source
// switches to its gap lane (VERT -> 1, VERT2 -> 2, HORI2 -> 4, else 3);
// a gap lane moves and closes on its open bit (1, 4, 2, 8 for lanes 1-4)
// or at the edge.  Returns the move emitted (-1 for a switch).
__device__ __forceinline__ int lane_step(int src, int op, int& state, int& m,
                                         int& n) {
  const bool h = state == 0;
  const bool diag = h && src == L_DIAG;
  const bool vert = state == 1 || state == 2;
  const bool hori = state >= 3;
  // H's next lane by source (nibble src of 0x42310), 3 past the codes
  const int to_gap = (unsigned)src <= 4u ? (0x42310 >> (4 * src)) & 7 : 3;
  // a gap lane's open bit (nibble state of 0x82410)
  const int bit = (0x82410 >> (4 * state)) & 15;
  const bool close = (op & bit) != 0 || (vert ? n == 0 : m == 0);
  const int emit = h ? (diag ? L_DIAG : -1) : (vert ? L_VERT : L_HORI);
  state = h ? to_gap : (close ? 0 : state);
  m -= (diag || vert);
  n -= (diag || hori);
  return emit;
}

// the device walk's dynamic index: negative slots wrap, then clamp
__device__ __forceinline__ int wrap_slot(int slot, int nslot) {
  if (slot < 0) slot += nslot;
  return min(max(slot, 0), nslot - 1);
}

// Where a pair's walk starts and stops.  m0, n0 per pair; lane0 and
// d_lo per pair or null (0); the range walk (range != 0) stops below
// m + n = max(d_lo, 1) and leaves m, n and lane in mf, nf, lanef.
struct Walk {
  const int32_t *m0, *n0, *lane0, *d_lo, *lw;
  int8_t* moves;
  int32_t *cnts, *mf, *nf, *lanef;
  int range;
};

__global__ void traceback_global_kernel(const int8_t* __restrict__ dirs,
                                        const int8_t* __restrict__ opens,
                                        Walk w, int B, int nsteps, int nslot,
                                        int max_iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int8_t* dp = dirs + (size_t)b * nsteps * nslot;
  const int8_t* op_ = opens + (size_t)b * nsteps * nslot;
  int8_t* mv = w.moves + (size_t)b * max_iters;
  for (int i = 0; i < max_iters; ++i) mv[i] = -1;

  int m = w.m0[b], n = w.n0[b];
  const int off = -(w.lw[b] - 1);
  int lane = w.lane0 ? w.lane0[b] : 0;   // 0=H 1=G 2=G2 3=F 4=F2
  const int d_lo = w.d_lo ? w.d_lo[b] : 0;
  const int floor_d = w.range ? max(d_lo, 1) : INT_MIN;
  int cnt = 0;
  for (int it = 0; (m > 0 || n > 0) && m + n >= floor_d && it < 3 * max_iters;
       ++it) {
    const int d = m + n;
    const int row = d - d_lo;
    int src = -1, op = 0;
    if (d > 0 && row >= 0 && row < nsteps) {
      const int slot = wrap_slot(off + (n - m), nslot);
      src = dp[(size_t)row * nslot + slot];
      op = op_[(size_t)row * nslot + slot];
    }
    const int emit = lane_step(src, op, lane, m, n);
    mv[min(cnt, max_iters - 1)] = (int8_t)emit;
    if (emit >= 0) ++cnt;
  }
  w.cnts[b] = min(cnt, max_iters);
  if (w.range) {
    w.mf[b] = m;
    w.nf[b] = n;
    w.lanef[b] = lane;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a read of both planes in device memory, kept out of line so that the
// compiler does not load it ahead where the step reads shared memory
__device__ __noinline__ int2 read_global(const int8_t* dirs,
                                         const int8_t* opens, long long a) {
  return make_int2(dirs[a], opens[a]);
}

// A tile's window in one plane: bytes [lo, hi) from the plane
// allocation's base, 16-byte aligned in device memory, holding rows
// [r0, r1] of the pair's plane except where clipped at the allocation's
// ends.
struct Window {
  long long lo, hi;
};

__device__ __forceinline__ Window tile_window(const int8_t* base,
                                              long long total,
                                              long long pair_off, int r0,
                                              int r1, int nslot) {
  const uintptr_t b = (uintptr_t)base;
  const uintptr_t first = (b + 15) & ~(uintptr_t)15;
  const uintptr_t last = (b + (uintptr_t)total) & ~(uintptr_t)15;
  uintptr_t lo = (b + pair_off + (long long)r0 * nslot) & ~(uintptr_t)15;
  uintptr_t hi =
      (b + pair_off + (long long)(r1 + 1) * nslot + 15) & ~(uintptr_t)15;
  lo = lo < first ? first : lo;
  hi = hi > last ? last : hi;
  if (hi < lo) hi = lo;
  return {(long long)(lo - b), (long long)(hi - b)};
}

__global__ void __launch_bounds__(kThreads)
    traceback_staged_kernel(const int8_t* __restrict__ dirs,
                            const int8_t* __restrict__ opens, Walk w,
                            int nsteps, int nslot, int max_iters, int T,
                            int cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // buffers: [stage 0 dirs][stage 0 opens][stage 1 dirs][stage 1 opens]
  int8_t* bufs = reinterpret_cast<int8_t*>(smem + kHead);
  int8_t* smv = bufs + 4 * (size_t)cap;
  const int b = blockIdx.x;

  for (int i = threadIdx.x; i < max_iters; i += blockDim.x) smv[i] = -1;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const long long total = (long long)gridDim.x * nsteps * nslot;
    const long long poff = (long long)b * nsteps * nslot;
    int m = w.m0[b], n = w.n0[b];
    const int off = -(w.lw[b] - 1);
    const int d_lo = w.d_lo ? w.d_lo[b] : 0;
    const int floor_d = w.range ? max(d_lo, 1) : INT_MIN;
    // rows rmin .. top in tiles of T, from the top down: a step reads row
    // d - d_lo of a step d >= 1
    const int top = min(m + n - d_lo, nsteps - 1);
    const int rmin = max(1 - d_lo, 0);
    const int ntiles = top >= rmin ? (top - rmin + T) / T : 0;

    auto issue = [&](int j) {
      const int r1 = top - j * T, r0 = max(r1 - T + 1, rmin);
      const Window wd = tile_window(dirs, total, poff, r0, r1, nslot);
      const Window wo = tile_window(opens, total, poff, r0, r1, nslot);
      const int s = j & 1;
      const uint32_t nd = (uint32_t)(wd.hi - wd.lo);
      const uint32_t no = (uint32_t)(wo.hi - wo.lo);
      // order this thread's reads of the buffer (generic proxy) before
      // the copy's writes (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&bars[s], nd + no);
      if (nd) bulk_g2s(bufs + (size_t)(2 * s) * cap, dirs + wd.lo, nd,
                       &bars[s]);
      if (no) bulk_g2s(bufs + (size_t)(2 * s + 1) * cap, opens + wo.lo, no,
                       &bars[s]);
    };

    int issued = 0;
    for (; issued < min(ntiles, 2); ++issued) issue(issued);

    int cur = -1;                 // the tile the walker reads
    int row_lo = top + 1;         // its lowest row
    Window wd{0, 0}, wo{0, 0};
    bool whole = false;           // the tile holds its rows whole
    int td = 0, to = 0;           // shared index 0 as a plane offset
    const int8_t* sd = bufs;
    const int8_t* so = bufs;
    int state = w.lane0 ? w.lane0[b] : 0;   // 0=H 1=G 2=G2 3=F 4=F2
    int cnt = 0;
    const int cap_iters = 3 * max_iters;
    for (int it = 0; (m > 0 || n > 0) && m + n >= floor_d && it < cap_iters;
         ++it) {
      const int d = m + n;
      const int row = d - d_lo;
      const bool inside = d > 0 && row >= 0 && row < nsteps;
      if (__builtin_expect(inside && row < row_lo, 0)) {
        while (row < row_lo) {    // cross into the next tile
          ++cur;
          const int s = cur & 1;
          mbar_wait(&bars[s], (cur >> 1) & 1);
          const int r1 = top - cur * T;
          row_lo = max(r1 - T + 1, rmin);
          wd = tile_window(dirs, total, poff, row_lo, r1, nslot);
          wo = tile_window(opens, total, poff, row_lo, r1, nslot);
          // the tile's rows whole in both windows: index shared memory
          // from the pair's plane offset
          const long long rlo = poff + (long long)row_lo * nslot;
          const long long rhi = poff + (long long)(r1 + 1) * nslot;
          whole = wd.lo <= rlo && wd.hi >= rhi && wo.lo <= rlo && wo.hi >= rhi;
          td = (int)(wd.lo - poff);
          to = (int)(wo.lo - poff);
          sd = bufs + (size_t)(2 * s) * cap;
          so = bufs + (size_t)(2 * s + 1) * cap;
          // the other buffer (tile cur - 1's) is free: fetch tile cur + 1
          if (issued == cur + 1 && issued < ntiles) issue(issued++);
        }
      }
      const int i = row * nslot + wrap_slot(off + (n - m), nslot);
      int src, op;
      if (__builtin_expect(whole || !inside, 1)) {
        // outside the planes the step reads byte 0 of a buffer, unused
        src = sd[inside ? i - td : 0];
        op = so[inside ? i - to : 0];
      } else {
        const long long a = poff + i;
        if (a >= wd.lo && a < wd.hi && a >= wo.lo && a < wo.hi) {
          src = sd[a - wd.lo];
          op = so[a - wo.lo];
        } else {
          const int2 g = read_global(dirs, opens, a);
          src = g.x;
          op = g.y;
        }
      }
      src = inside ? src : -1;
      op = inside ? op : 0;
      const int emit = lane_step(src, op, state, m, n);
      smv[min(cnt, max_iters - 1)] = (int8_t)emit;
      cnt += emit >= 0;
    }
    // no copy may still be writing when the block exits
    for (int j = cur + 1; j < issued; ++j) mbar_wait(&bars[j & 1], (j >> 1) & 1);
    w.cnts[b] = min(cnt, max_iters);
    if (w.range) {
      w.mf[b] = m;
      w.nf[b] = n;
      w.lanef[b] = state;
    }
  }
  __syncthreads();
  int8_t* mv = w.moves + (size_t)b * max_iters;
  for (int i = threadIdx.x; i < max_iters; i += blockDim.x) mv[i] = smv[i];
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// a 16-byte copy from device memory into shared memory (cp.async), and
// an arrival on an mbarrier once this thread's copies so far have landed
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the window variant: its two warps, and its most stages
constexpr int kWinThreads = 64;
constexpr int kMaxStages = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// Where row ``row``'s window lies in a plane, in bytes from the plane
// allocation's base (16-byte aligned): from the row's slot c0 rounded
// down to 16 bytes, Wd bytes, clipped to [0, last).
__device__ __forceinline__ void row_window(long long poff, int row,
                                           int nslot, int c0, int Wd,
                                           long long last, long long& lo,
                                           long long& hi) {
  lo = (poff + (long long)row * nslot + c0) & ~15LL;
  lo = lo < 0 ? 0 : lo;
  hi = lo + Wd < last ? lo + Wd : last;
}

__global__ void __launch_bounds__(kWinThreads)
    traceback_window_kernel(const int8_t* __restrict__ dirs,
                            const int8_t* __restrict__ opens, Walk w,
                            int nsteps, int nslot, int max_iters, int T,
                            int Wd, int NS) {
  extern __shared__ __align__(128) unsigned char smem[];
  // head: full[NS] and empty[NS] mbarriers, each stage's window start,
  // whether its windows all lie whole in the planes, the walker's slot
  // on leaving it, the walker's done flag and the tiles the copier
  // issued
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* cs0 = reinterpret_cast<int*>(empty + kMaxStages);
  int* cwhole = cs0 + kMaxStages;
  int* hint = cwhole + kMaxStages;
  volatile int* done = hint + kMaxStages;
  int* issued = hint + kMaxStages + 1;
  int* walked = hint + kMaxStages + 2;   // the walker's last tile and move
  // rows of a multiple of 16 slots: every row's window starts at the same
  // slot, c0 rounded down to 16 (the planes are 16-byte aligned)
  const bool even_rows = nslot % 16 == 0;

  // stage s: T rows of Wd bytes of dirs, then of opens
  int8_t* bufs = reinterpret_cast<int8_t*>(smem + kHead);
  const size_t stage = (size_t)T * Wd;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;

  const long long total = (long long)gridDim.x * nsteps * nslot;
  const long long last = total & ~15LL;
  const long long poff = (long long)b * nsteps * nslot;
  int m = w.m0[b], n = w.n0[b];
  const int off = -(w.lw[b] - 1);
  const int d_lo = w.d_lo ? w.d_lo[b] : 0;
  const int floor_d = w.range ? max(d_lo, 1) : INT_MIN;
  // rows rmin .. top in tiles of T, from the top down: a step reads row
  // d - d_lo of a step d >= 1
  const int top = min(m + n - d_lo, nsteps - 1);
  const int rmin = max(1 - d_lo, 0);
  const int ntiles = top >= rmin ? (top - rmin + T) / T : 0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      // the copier's 32 lanes' copies and its lane 0's window start
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 1);
    }
    *done = 0;
    *issued = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int8_t* mv = w.moves + (size_t)b * max_iters;
  int hiw = -1;                         // the last move index written
  if (tid >= 32) {
    // the copier: tile j into stage j % NS once the walker left tile
    // j - NS, centred on the slot where it left it
    const int slot0 = wrap_slot(off + (n - m), nslot);
    int j = 0;
    for (; j < ntiles; ++j) {
      const int s = j % NS;
      int h = slot0;
      if (j >= NS) {
        int ok = 0;
        if (lane == 0) {
          const uint32_t ph = ((j / NS) - 1) & 1;
          while (!(ok = mbar_try_wait(&empty[s], ph)) && !*done) {
          }
          h = hint[s];
        }
        ok = __shfl_sync(kFullMask, ok, 0);
        h = __shfl_sync(kFullMask, h, 0);
        if (!ok) break;                 // the walk ended
      }
      const int c0 = h - Wd / 2;
      const int r1 = top - j * T, r0 = max(r1 - T + 1, rmin);
      int clipped = 0;
      for (int row = r1 - lane; row >= r0; row -= 32) {
        long long lo, hi;
        row_window(poff, row, nslot, c0, Wd, last, lo, hi);
        clipped |= hi - lo != Wd ||
                   lo != poff + (long long)row * nslot + (c0 & ~15);
      }
      clipped = __any_sync(kFullMask, clipped);
      if (lane == 0) {
        cs0[s] = c0;
        cwhole[s] = even_rows && !clipped;
        mbar_arrive(&full[s]);
      }
      __syncwarp();
      // the tile's rows of both planes in 16-byte pieces over the lanes;
      // each lane's pieces arrive on the stage's barrier when they land
      const int cpr = Wd / 16, per_plane = (r1 - r0 + 1) * cpr;
      int8_t* sd = bufs + 2 * stage * s;
      for (int q = lane; q < 2 * per_plane; q += 32) {
        const int plane = q >= per_plane;
        const int ri = (q - plane * per_plane) / cpr;
        const int k = 16 * (q - plane * per_plane - ri * cpr);
        long long lo, hi;
        row_window(poff, r1 - ri, nslot, c0, Wd, last, lo, hi);
        if (lo + k < hi)
          cp_async16(sd + plane * stage + (size_t)ri * Wd + k,
                     (plane ? opens : dirs) + lo + k);
      }
      cp_async_arrive(&full[s]);
    }
    if (lane == 0) *issued = j;
  } else if (tid == 0) {
    int cur = -1;                 // the tile the walker reads
    int row_lo = top + 1;         // its lowest row
    int r1c = 0, c0c = 0;         // its top row and window start
    bool whole = false;           // its windows start at slot c0c & ~15
    const int8_t* sd = bufs;
    const int8_t* so = bufs;
    int state = w.lane0 ? w.lane0[b] : 0;   // 0=H 1=G 2=G2 3=F 4=F2
    int cnt = 0;
    const int cap_iters = 3 * max_iters;
    for (int it = 0; (m > 0 || n > 0) && m + n >= floor_d && it < cap_iters;
         ++it) {
      const int d = m + n;
      const int row = d - d_lo;
      const bool inside = d > 0 && row >= 0 && row < nsteps;
      const int slot = wrap_slot(off + (n - m), nslot);
      if (__builtin_expect(inside && row < row_lo, 0)) {
        while (row < row_lo) {    // cross into the next tile
          if (cur >= 0) {
            hint[cur % NS] = slot;
            mbar_arrive(&empty[cur % NS]);
          }
          ++cur;
          const int s = cur % NS;
          mbar_wait(&full[s], (cur / NS) & 1);
          r1c = top - cur * T;
          row_lo = max(r1c - T + 1, rmin);
          c0c = cs0[s];
          whole = cwhole[s];
          sd = bufs + 2 * stage * s;
          so = sd + stage;
        }
      }
      int src = -1, op = 0;
      if (inside) {
        // the slot's byte in its row's window: in a whole tile of even
        // rows at slot - (c0 & ~15), else from the window's bounds
        const long long a = poff + (long long)row * nslot + slot;
        int at = slot - (c0c & ~15);
        bool hit = (unsigned)at < (unsigned)Wd;
        if (!whole) {
          long long lo, hi;
          row_window(poff, row, nslot, c0c, Wd, last, lo, hi);
          at = (int)(a - lo);
          hit = a >= lo && a < hi;
        }
        if (hit) {
          const int i = (r1c - row) * Wd + at;
          src = sd[i];
          op = so[i];
        } else {
          const int2 g = read_global(dirs, opens, a);
          src = g.x;
          op = g.y;
        }
      }
      const int emit = lane_step(src, op, state, m, n);
      hiw = min(cnt, max_iters - 1);
      mv[hiw] = (int8_t)emit;
      cnt += emit >= 0;
    }
    *done = 1;
    w.cnts[b] = min(cnt, max_iters);
    if (w.range) {
      w.mf[b] = m;
      w.nf[b] = n;
      w.lanef[b] = state;
    }
    walked[0] = cur;
    walked[1] = hiw;
  }
  __syncthreads();
  // no copy may still be writing when the block exits
  const int cur = walked[0];
  if (tid == 0)
    for (int j = cur + 1; j < *issued; ++j)
      mbar_wait(&full[j % NS], (j / NS) & 1);
  // the moves past the last written: -1
  for (int i = walked[1] + 1 + tid; i < max_iters; i += kWinThreads)
    mv[i] = -1;
}

}  // namespace

// variant 0: global (one thread a pair, planes in device memory);
// variant 1: staged (one block a pair, tiles of tile_rows full rows in two
// buffers of width bytes a plane); variant 2: window (one block of two
// warps a pair, tiles of tile_rows rows of a window of width bytes a
// plane in ``stages`` stages; both planes 16-byte aligned); smem_bytes in
// all.  m0, n0, lw per pair; lane0 and d_lo per pair or null (0); range
// 1: the range walk, which leaves where it stopped in mf, nf, lanef.
extern "C" int traceback_launch(const void* dirs, const void* opens,
                                const void* m0, const void* n0,
                                const void* lane0, const void* d_lo,
                                const void* lw, void* moves, void* cnts,
                                void* mf, void* nf, void* lanef, int B,
                                int nsteps, int nslot, int max_iters,
                                int range, int variant, int tile_rows,
                                int width, int stages, int smem_bytes,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t *d8 = (const int8_t*)dirs, *o8 = (const int8_t*)opens;
  const Walk w{(const int32_t*)m0, (const int32_t*)n0,
               (const int32_t*)lane0, (const int32_t*)d_lo,
               (const int32_t*)lw, (int8_t*)moves, (int32_t*)cnts,
               (int32_t*)mf, (int32_t*)nf, (int32_t*)lanef, range};
  if (range && (mf == nullptr || nf == nullptr || lanef == nullptr))
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    const int threads = 32;
    traceback_global_kernel<<<(B + threads - 1) / threads, threads, 0, st>>>(
        d8, o8, w, B, nsteps, nslot, max_iters);
    return (int)cudaGetLastError();
  }
  if (variant == 2) {
    if (tile_rows < 1 || width < 16 || width % 16 != 0 || stages < 2 ||
        stages > kMaxStages || ((uintptr_t)dirs & 15) != 0 ||
        ((uintptr_t)opens & 15) != 0 ||
        (long long)tile_rows * width >= (1LL << 31) ||
        (long long)smem_bytes < kHead + 2LL * stages * tile_rows * width)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        traceback_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    traceback_window_kernel<<<B, kWinThreads, smem_bytes, st>>>(
        d8, o8, w, nsteps, nslot, max_iters, tile_rows, width, stages);
    return (int)cudaGetLastError();
  }
  if (variant != 1 || tile_rows < 1 || width < tile_rows * nslot + 32 ||
      width % 128 != 0 || (long long)nsteps * nslot >= (1LL << 31) ||
      smem_bytes < kHead + 4 * width + max_iters)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      traceback_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  traceback_staged_kernel<<<B, kThreads, smem_bytes, st>>>(
      d8, o8, w, nsteps, nslot, max_iters, tile_rows, width);
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of a variant's kernel
extern "C" int traceback_attrs(int variant, void* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, variant == 0   ? (const void*)traceback_global_kernel
             : variant == 2 ? (const void*)traceback_window_kernel
                            : (const void*)traceback_staged_kernel);
  if (err != cudaSuccess) return (int)err;
  ((int*)out)[0] = attr.numRegs;
  ((int*)out)[1] = (int)attr.localSizeBytes;
  return 0;
}
