// Kernel K4w: the fwd2h traceback walk over K4's wave-layout planes.
//
// Replaces prrn_aln_tpu/ops/pallas_spliced_h.py::_device_walk (:1016), a
// lax.while_loop on the TPU.  Its plain version is
// ops/spliced_h.py::walk_h_ref, the same state machine as a scalar
// Python loop; both emit the same knots, in backward order, and stop at
// the same cell after the same number of steps.
//
// What bounds it on the card: one dependent chain of at most
// MAXIT = 6 (M + N + 8) steps, each a read of the ev plane (and, for the
// diagonal test, of the cell below-left) at an address that depends on
// the previous step: latency, not bandwidth.  From device memory (L2,
// where K4 left the planes) a read is one L2 round trip, ~300 cycles or
// more.
//
// What the design does about it (after K3, csrc/traceback.cu): the cell
// (m, n) lies on wave ti = 3 m + n - t_min, row m, word ti * MR + m of
// ev.  Every step but a jump lowers ti by 0 to 6 and m by 0 or 1 (a step
// that lowers m lowers ti by at least 3), and no step raises m.  So the
// cells of the next D waves below the walker lie in the rows
// [m - ceil(D / 3) - 1, m] of those waves.  One block walks: one walker
// thread, and staging warps that keep a ring of D waves below the
// walker in shared memory.  For each wave the ring holds a window of
// the ev plane of S >= R + 3 words, R = ceil(D / 3) + 2 rows ending at
// the walker's published row, rounded out to 16 bytes and loaded with
// 16-byte loads.  A staging warp stages the waves of its residue class
// (slot = wave mod D, wave mod stagers = its index) from the walker's
// lowest wave down, and publishes each slot with a release store of its
// tag (the wave and the window's first word).  The walker reads a cell
// from shared memory when its slot's tag (an acquire load) names the
// wave and the window holds the word, and from device memory
// elsewhere: above its lowest wave, past a jump (n = jd value,
// hundreds of waves down for an intron) until the ring restarts there,
// or where a window was clipped.  A slot is overwritten only with a
// lower wave, and only once its old wave lies above a lowest wave the
// walker published, which only falls: so a slot the walker may read is
// never being written.  A step holds its cell and the cell below-left
// (the diagonal test); a diagonal move, most of a walk, takes the latter
// as its next cell, so it reads one cell, one move ahead.  jd is read
// only on the four jump branches, from device memory.  The knots are
// stores off the chain; the counters are written at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EVH_SJ = 1 << 2, EVH_JXH = 1 << 7, EVH_JXF = 1 << 8,
              EVH_JXG = 1 << 9, EVH_CSH = 1 << 10;
constexpr int kStagers = 4;          // staging warps beside the walker
                                     // (a power of two: each slot of the
                                     // ring belongs to one of them)
constexpr int kChunks = 6;           // 16-byte loads a staging lane keeps
                                     // in flight
constexpr int kHead = 16;            // the published floor and done flag

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.cta.shared.b64 %0, [%1];"
               : "=l"(v)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(p)),
               "l"(v)
               : "memory");
}

// a read of device memory that the compiler cannot move ahead of the
// branch it sits in (the step reads shared memory where it can)
__device__ __forceinline__ int ld_global(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// a cell the ring does not hold, from device memory, out of line: the
// step's common path then holds no load of device memory
__device__ __noinline__ int read_miss(const int* ev, int g) {
  return ld_global(ev + g);
}

__device__ __forceinline__ uint64_t pack(int hi, int lo) {
  return ((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo;
}

// The walker: the state machine of walk_h_ref.  Counters and knots go
// to buf: cnt, m, n, steps, reads of the ring, reads of device memory,
// two words unused, then the knots as (m, n) pairs.
__device__ void walk(const int* __restrict__ ev, const int* __restrict__ jd,
                     int* __restrict__ buf, int T, int MR, int t_min, int om,
                     int on, int maxit, int D, int S,
                     volatile uint64_t* pub, const uint64_t* tags,
                     const int* ring) {
  int floor_w = 3 * om + on - t_min;   // the lowest wave published
  int floor_m = om;                    // the walker's row there
  int hits = 0, misses = 0;
  // one cell of ev (wave t, row mm), or -1 outside the planes: from its
  // slot where the ring holds it, else from device memory
  auto cell = [&](int t, int mm) -> int {
    const bool in = mm >= 1 && mm < MR && t >= 0 && t < T;
    const int slot = t & (D - 1);
    const uint64_t g = ld_acquire(tags + slot);
    const int o = t * MR + mm - (int)(uint32_t)g;
    const bool hit = in && t <= floor_w && (int)(g >> 32) == t &&
                     (unsigned)o < (unsigned)S;
    int x = ring[hit ? slot * S + o : 0];
    hits += hit;
    if (__builtin_expect(in && !hit, 0)) {
      ++misses;
      x = read_miss(ev, t * MR + mm);
    }
    return in ? x : -1;
  };
  int m = om, n = on, st = 0, cnt = 0, it = 0;
  int* knots = buf + 8;
  auto push = [&](int km, int kn) {
    knots[2 * cnt] = km;
    knots[2 * cnt + 1] = kn;
    ++cnt;
  };
  // publish the walker's lowest wave, then read the cell (m, n) of wave
  // ti and the cell (m - 1, n - 3) below-left, for the diagonal test
  int ti = 3 * m + n - t_min;
  *pub = pack(floor_w, floor_m);
  int e = cell(ti, m);
  int e2 = cell(ti - 6, m - 1);
  while (it < maxit) {
    if (m <= 0 || e < 0) break;
    if (st == 0 && (e & (3 | EVH_JXH | EVH_SJ)) == 0) {
      // the diagonal move, most of a walk: the cell below-left is read
      // already, so a step is one read ahead
      if (m - 1 <= 0 || e2 < 0 || (e2 & 3) != 0) push(m - 1, n - 3);
      --m;
      n -= 3;
      ti -= 6;
      ++it;
      if (ti >= 0 && ti < floor_w) {
        floor_w = ti;
        floor_m = m;
        *pub = pack(floor_w, floor_m);
      }
      e = e2;
      e2 = cell(ti - 6, m - 1);
      continue;
    }
    const int w = e & 3;
    const bool jxh = (e & EVH_JXH) != 0, csh = (e & EVH_CSH) != 0;
    const bool s0 = st == 0 && w == 0;
    const bool b_jxh = s0 && jxh;
    const bool b_sj = s0 && !jxh && (e & EVH_SJ) != 0;
    const bool b_jxf = st == 1 && (e & EVH_JXF) != 0;
    const bool b_h = st == 1 && !b_jxf;
    const bool b_jxg = st == 2 && (e & EVH_JXG) != 0;
    const bool b_v = st == 2 && !b_jxg;
    const bool jump = b_jxh || b_jxf || b_jxg;
    const int hk = (e >> 5) & 3, vk = (e >> 3) & 3;
    int jdv = 0;
    if (jump || b_sj) {
      const int k = b_jxh ? 0 : b_sj ? 3 : b_jxf ? 1 : 2;
      const int tc = min(max(ti, 0), T - 1);
      const int mc = min(max(m, 0), MR - 1);
      jdv = ld_global(jd + ((size_t)tc * 4 + k) * MR + mc);
      push(b_sj ? m - 1 : m, b_sj ? jdv : n);
      if (jump) push(m, jdv);
      if (b_jxh && csh) {
        const int e3 = cell(3 * (m - 1) + jdv - 3 - t_min, m - 1);
        if (m - 1 <= 0 || e3 < 0 || (e3 & 3) != 0) push(m - 1, jdv - 3);
      }
    }
    // the next state: a horizontal move lowers n by 3, 1, 2, 3 for hk =
    // 0 .. 3; a vertical one by 0, 2, 1, 0 for vk = 0 .. 3
    const int dh = (0x3213 >> (4 * hk)) & 15;
    const int dv = (0x0120 >> (4 * vk)) & 15;
    const int n_next = b_jxh ? (csh ? jdv - 3 : jdv)
                       : (b_sj || b_jxf || b_jxg) ? jdv
                       : b_h ? n - dh
                       : b_v ? n - dv
                             : n;
    const int st_next = (b_jxh || b_sj) ? 0
                        : st == 0 ? w
                        : b_jxf ? 1
                        : b_jxg ? 2
                        : b_h ? (hk == 0 ? 1 : 0)
                        : b_v ? (vk == 0 ? 2 : 0)
                              : 0;
    m -= (b_jxh && csh) || b_sj || b_v;
    n = n_next;
    st = st_next;
    ++it;
    ti = 3 * m + n - t_min;
    if (ti >= 0 && ti < floor_w) {
      floor_w = ti;
      floor_m = m;
    }
    *pub = pack(floor_w, floor_m);
    e = cell(ti, m);
    e2 = cell(ti - 6, m - 1);
  }
  buf[0] = cnt;
  buf[1] = m;
  buf[2] = n;
  buf[3] = it;
  buf[4] = hits;
  buf[5] = misses;
}

// A staging warp: the waves x with x mod kStagers == s, from the walker's
// lowest wave f down to f - D + 1, in batches of as many waves as
// kChunks loads a lane hold.  Each wave's window: S words from the
// 16-byte boundary at or below word x * MR + mp - R + 1, mp the walker's
// row at f; words of a chunk that is not whole inside the plane are read
// one by one.
__device__ void stage(const int* __restrict__ ev, int total, int MR, int D,
                      int R, int S, int s, volatile uint64_t* pub,
                      volatile int* done, uint64_t* tags, int* ring) {
  const int lane = threadIdx.x & 31;
  const int cpw = S / 4;                         // chunks a wave
  const int per_batch = max(1, 32 * kChunks / cpw);
  const int off = (int)(((uintptr_t)ev >> 2) & 3);   // words past 16 B
  int cursor = 0x7fffffff;                       // next wave to stage
  while (true) {
    uint64_t pv = 0;
    int stop = 0;
    if (lane == 0) {
      pv = *pub;
      stop = *done;
    }
    pv = __shfl_sync(0xffffffffu, pv, 0);
    if (__shfl_sync(0xffffffffu, stop, 0)) break;
    const int f = (int)(pv >> 32), mp = (int)(uint32_t)pv;
    if (cursor > f) cursor = f - ((f - s) % kStagers + kStagers) % kStagers;
    const int lowest = max(f - D + 1, 0);
    if (cursor < lowest) {
      __nanosleep(32);
      continue;
    }
    int nw = 0;
    while (nw < per_batch && cursor - nw * kStagers >= lowest) ++nw;
    int4 v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + 32 * k;
      if (c >= nw * cpw) break;
      const int x = cursor - (c / cpw) * kStagers;
      const int want = x * MR + mp - R + 1;
      const int a0 = want - (((want + off) % 4) + 4) % 4;
      const int g = a0 + 4 * (c % cpw);
      if (g >= 0 && g + 4 <= total) {
        v[k] = *reinterpret_cast<const int4*>(ev + g);
      } else {
        v[k].x = g >= 0 && g < total ? ev[g] : 0;
        v[k].y = g + 1 >= 0 && g + 1 < total ? ev[g + 1] : 0;
        v[k].z = g + 2 >= 0 && g + 2 < total ? ev[g + 2] : 0;
        v[k].w = g + 3 >= 0 && g + 3 < total ? ev[g + 3] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + 32 * k;
      if (c >= nw * cpw) break;
      const int x = cursor - (c / cpw) * kStagers;
      *reinterpret_cast<int4*>(ring + (x & (D - 1)) * S + 4 * (c % cpw)) = v[k];
    }
    __threadfence_block();
    __syncwarp();
    if (lane < nw) {
      const int x = cursor - lane * kStagers;
      const int want = x * MR + mp - R + 1;
      const int a0 = want - (((want + off) % 4) + 4) % 4;
      st_release(tags + (x & (D - 1)), pack(x, a0));
    }
    cursor -= nw * kStagers;
  }
}

__global__ void __launch_bounds__(32 * (1 + kStagers))
    spliced_h_walk_kernel(const int* __restrict__ ev,
                          const int* __restrict__ jd, int* __restrict__ buf,
                          int T, int MR, int t_min, int om, int on, int maxit,
                          int D, int R, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  volatile uint64_t* pub = reinterpret_cast<volatile uint64_t*>(smem);
  volatile int* done = reinterpret_cast<volatile int*>(smem + 8);
  uint64_t* tags = reinterpret_cast<uint64_t*>(smem + kHead);
  int* ring = reinterpret_cast<int*>(tags + D);
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < D; i += blockDim.x) tags[i] = pack(-1, 0);
  if (threadIdx.x == 0) {
    *pub = pack(3 * om + on - t_min, om);
    *done = 0;
  }
  __syncthreads();
  if (warp == 0) {
    if (threadIdx.x == 0) {
      walk(ev, jd, buf, T, MR, t_min, om, on, maxit, D, S, pub, tags, ring);
      *done = 1;
    }
  } else {
    stage(ev, T * MR, MR, D, R, S, warp - 1, pub, done, tags, ring);
  }
}

}  // namespace

// depth: ring waves (a power of two); rows: R; slot_words: S, a multiple
// of 4 and at least R + 3; smem_bytes: kHead + 8 D + 4 D S
extern "C" int spliced_h_walk_launch(const void* ev, const void* jd,
                                     void* buf, int T, int MR, int t_min,
                                     int om, int on, int maxit, int depth,
                                     int rows, int slot_words, int smem_bytes,
                                     void* stream) {
  if (depth < kStagers || (depth & (depth - 1)) != 0 || slot_words % 4 != 0 ||
      slot_words < rows + 3 || rows < 1 ||
      smem_bytes < kHead + 8 * depth + 4 * depth * slot_words ||
      (long long)T * MR >= (1LL << 31) || T < 1 || MR < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      spliced_h_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  spliced_h_walk_kernel<<<1, 32 * (1 + kStagers), smem_bytes,
                          (cudaStream_t)stream>>>(
      (const int*)ev, (const int*)jd, (int*)buf, T, MR, t_min, om, on, maxit,
      depth, rows, slot_words);
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of the kernel
extern "C" int spliced_h_walk_attrs(void* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, spliced_h_walk_kernel);
  if (err != cudaSuccess) return (int)err;
  ((int*)out)[0] = attr.numRegs;
  ((int*)out)[1] = (int)attr.localSizeBytes;
  return 0;
}
