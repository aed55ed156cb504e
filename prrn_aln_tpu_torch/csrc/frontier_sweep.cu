// Kernel K6: the band-frontier rows of one long banded pair, in two
// entry points.
//
// Replaces the row body of prrn_aln_tpu/ops/frontier.py::
// frontier_pairwise_score (the lax.scan over the rows of a shard_map whose
// shards pass their boundary lanes by ppermute).  Lane j of row m holds
// column n = m + lw + j of one pair's banded affine DP; a shard holds Wl
// lanes from j0.  A row step, from the previous row's H and G:
//
//   G0 = max(Hs - v, Gs) - u and X = max(H + s, G0), Hs and Gs being H
//   and G shifted one lane left with the right neighbour's first lanes
//   (hedge, gedge) at the end, s the row's substitution scores;
//   C = Xl - (v + u), Xl being X shifted one lane right with the left
//   neighbour's last lane (xin) at the front (the left column's value on
//   the lane of column 0 while that column is in the band), T = C + j u;
//   M = max(carry, the inclusive running maximum of T), carry being the
//   running maximum of the shards to the left; E = M - j u,
//   H0 = max(X, E), NEG_SENT off the band.
//
// The scores are looked up here: s = mtx[a[m], b[n]], NEG_SENT where n is
// off 0 <= n < lb (ops/frontier.py::band_rows packs the same on the host
// for the plain version).  The plain version is ops/frontier.py::
// frontier_row_ref, which follows the JAX function's f32 arithmetic as
// XLA compiles it on the CPU: X - v - u folded into X - (v + u), and the
// left column's v + (m + 1) u one fused multiply-add (__fmaf_rn here);
// every other operation is rounded on its own (built with -fmad=false).
// A maximum is exact, so the running maximum's grouping does not matter.
//
// What bounds it on the card: not its bytes (a, b, mtx and the last rows)
// nor its operations (about 14 a lane and row), but the chain of a row's
// dependent steps, row after row.  The design:
//
//   K6s (frontier_sweep_kernel): the whole band of a pair with nothing
//   arriving from other ranks, every row in one launch, one block.  A
//   thread keeps K consecutive lanes of H and G in registers; the row's
//   neighbour lanes come from the previous row by __shfl_{up,down}_sync,
//   and across a warp's edge from what the neighbour warp published in
//   shared memory.  A thread recomputes X of the lane left of its own from
//   the previous row, so X never crosses threads.  The running maximum is
//   a serial maximum over the thread's lanes (kept a lane), a warp shuffle
//   scan of the threads' maxima, and, after the row's one __syncthreads,
//   one redux (__reduce_max_sync on the floats' order as integers) of the
//   earlier warps' totals.  Each warp publishes, before that barrier, its
//   total and the X, T and G0 of its boundary lanes, so that after it
//   every warp computes its neighbours' boundary H0 for the next row
//   itself: one barrier a row, the slots double-buffered by the row's
//   parity.  mtx lives in shared memory; the next row's column code and
//   a[m + 1] are loaded ahead of the barrier.
//
//   K6r (frontier_row_kernel): one row of one shard a launch, for a ring
//   of ranks (the values from the neighbours arrive between rows) and for
//   shards wider than K6s holds.  H and G are read from device memory, the
//   lanes looped over the block in chunks with the running maximum carried
//   from chunk to chunk; it writes H0, G0 and the four values the row
//   sends on: H0[0] and G0[0] to the left neighbour, X[Wl - 1] and
//   max(carry, M[Wl - 1]) to the right.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
// the largest alphabet whose matrix K6s keeps in static-size shared memory
constexpr int kMaxAlpha = 64;
// what a warp of K6s publishes each row: its total of T, and X, T, G0 of
// its first lane and X of its last
enum { kTot, kXFirst, kTFirst, kGFirst, kXLast, kSlots };

__device__ __forceinline__ int code(const int* __restrict__ b, int n,
                                    int lb) {
  return n >= 0 && n < lb ? __ldg(b + n) : -1;
}

__device__ __forceinline__ float score(const float* mrow, int c) {
  return c >= 0 ? mrow[c] : kNegSent;
}

// (m + lw) + jg in f32, the JAX function's order, inside the band
__device__ __forceinline__ bool valid(float base, int jg, int lb, int W) {
  const float nvec = base + (float)jg;
  return nvec >= 0.0f && nvec < (float)lb && jg < W;
}

// C + j u of lane jg, xl being X of the lane to its left
__device__ __forceinline__ float t_of(float xl, float base, int jg,
                                      bool colb_ok, float colb, float vu,
                                      float u) {
  float c = xl - vu;
  if (base + (float)jg == 0.0f && colb_ok) c = colb - vu;
  return c + (float)jg * u;
}

__device__ __forceinline__ float warp_scan_max(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = fmaxf(x, y);
  }
  return x;
}

// the maximum of x over the warp: one redux on the integers whose order
// is that of the floats (a negative float's magnitude bits flipped)
__device__ __forceinline__ float ordered_max(float x) {
  int i = __float_as_int(x);
  i = __reduce_max_sync(kFull, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

template <int K>
__global__ void __launch_bounds__(1024) frontier_sweep_kernel(
    const float* __restrict__ Hin, const float* __restrict__ Gin,
    float* __restrict__ Hout, float* __restrict__ Gout,
    const int* __restrict__ a, const int* __restrict__ b,
    const float* __restrict__ mtx, int nalpha, int la, int lb, int Wl,
    int lw, int W, float u, float v) {
  __shared__ float mtx_s[kMaxAlpha * kMaxAlpha];
  __shared__ float pub[2][kSlots][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int jb = t * K;                       // this thread's first lane
  const int nact = min(max(Wl - jb, 0), K);   // its lanes inside the shard
  // one shard of world 1: nothing arrives from other ranks
  const float hedge = kNegSent, gedge = kNegSent, xin = kNegSent;
  const float carry = kNevsel;
  const float vu = v + u;
  for (int i = t; i < nalpha * nalpha; i += blockDim.x) mtx_s[i] = mtx[i];
  float h[K], g[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    h[i] = i < nact ? Hin[jb + i] : hedge;
    g[i] = i < nact ? Gin[jb + i] : gedge;
  }
  // the previous row's lanes beside this thread's: jb - 1 (H), jb + K (H, G)
  float lh = jb >= 1 && jb - 1 < Wl ? Hin[jb - 1] : kNegSent;
  float rh = jb + K < Wl ? Hin[jb + K] : hedge;
  float rg = jb + K < Wl ? Gin[jb + K] : gedge;
  // column codes of lanes jb - 1 .. jb + K - 1 on the current row
  int c[K + 1];
#pragma unroll
  for (int i = 0; i <= K; ++i) c[i] = code(b, lw + jb - 1 + i, lb);
  int am = la > 0 ? __ldg(a) : 0;
  __syncthreads();
  for (int m = 0; m < la; ++m) {
    // the next row's one new code and a[m + 1], ahead of the barrier
    const int cn = code(b, m + lw + jb + K, lb);
    const int an = m + 1 < la ? __ldg(a + m + 1) : 0;
    const float* mrow = mtx_s + am * nalpha;
    const float mf = (float)m;
    const float base = mf + (float)lw;
    const float colb = -__fmaf_rn(mf + 1.0f, u, v);
    const bool colb_ok = m < -lw;
    // X of lane jb - 1, from the previous row
    const float xp = t == 0 ? xin
                            : fmaxf(lh + score(mrow, c[0]),
                                    fmaxf(h[0] - v, g[0]) - u);
    // G0 and X in place of G and H; T's running maximum over the thread's
    // lanes
    float run[K], xl = xp;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float hs = i + 1 < K ? h[i + 1] : rh;
      const float gs = i + 1 < K ? g[i + 1] : rg;
      const float g0 = fmaxf(hs - v, gs) - u;
      const float x = fmaxf(h[i] + score(mrow, c[i + 1]), g0);
      const float tt = i < nact ? t_of(xl, base, jb + i, colb_ok, colb, vu, u)
                                : kNevsel;
      run[i] = i == 0 ? tt : fmaxf(run[i - 1], tt);
      xl = x;
      h[i] = x;
      g[i] = g0;
    }
    const float incl = warp_scan_max(run[K - 1], lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNevsel;
    float(*slot)[32] = pub[m & 1];
    if (lane == 31) {
      slot[kTot][warp] = incl;
      slot[kXLast][warp] = h[K - 1];
    }
    if (lane == 0) {
      slot[kXFirst][warp] = h[0];
      slot[kTFirst][warp] = run[0];
      slot[kGFirst][warp] = g[0];
    }
    __syncthreads();
    // the maximum of T over the warps to the left
    const float pw = ordered_max(lane < warp ? slot[kTot][lane] : kNevsel);
    // M, E and H0 in place of X
    const float pre = fmaxf(pw, excl);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int jg = jb + i;
      const float hh = fmaxf(h[i], fmaxf(fmaxf(run[i], pre), carry) -
                                       (float)jg * u);
      h[i] = i < nact ? (valid(base, jg, lb, W) ? hh : kNegSent) : hedge;
      if (i >= nact) g[i] = gedge;
    }
    // the neighbour warps' boundary lanes of this row, from what they
    // published: H0 and G0 of the next warp's first lane, H0 of the
    // previous warp's last
    const int jr = (warp + 1) * 32 * K;
    float erh = hedge, erg = gedge, elh = kNegSent;
    if (jr < Wl) {
      const float mm = fmaxf(fmaxf(slot[kTFirst][warp + 1],
                                   fmaxf(pw, slot[kTot][warp])),
                             carry);
      const float hh = fmaxf(slot[kXFirst][warp + 1], mm - (float)jr * u);
      erh = valid(base, jr, lb, W) ? hh : kNegSent;
      erg = slot[kGFirst][warp + 1];
    }
    if (warp > 0) {
      const int jl = warp * 32 * K - 1;
      const float hh = fmaxf(slot[kXLast][warp - 1],
                             fmaxf(pw, carry) - (float)jl * u);
      elh = valid(base, jl, lb, W) ? hh : kNegSent;
    }
    const float dh = __shfl_down_sync(kFull, h[0], 1);
    const float dg = __shfl_down_sync(kFull, g[0], 1);
    const float uh = __shfl_up_sync(kFull, h[K - 1], 1);
    rh = lane == 31 ? erh : dh;
    rg = lane == 31 ? erg : dg;
    lh = lane == 0 ? elh : uh;
    if (jb + K >= Wl) {
      rh = hedge;
      rg = gedge;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = c[i + 1];
    c[K] = cn;
    am = an;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < nact) {
      Hout[jb + i] = h[i];
      Gout[jb + i] = g[i];
    }
  }
}

__global__ void __launch_bounds__(1024) frontier_row_kernel(
    const float* __restrict__ H, const float* __restrict__ G,
    float* __restrict__ H0, float* __restrict__ G0,
    float* __restrict__ sends, const int* __restrict__ a,
    const int* __restrict__ b, const float* __restrict__ mtx, int nalpha,
    int m, int j0, int lb, int Wl, int lw, int W, float hedge, float gedge,
    float xin, float carry, float u, float v) {
  __shared__ float tot[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* mrow = mtx + __ldg(a + m) * nalpha;
  const float mf = (float)m;
  const float base = mf + (float)lw;
  const float vu = v + u;
  const float colb = -__fmaf_rn(mf + 1.0f, u, v);
  const bool colb_ok = m < -lw;
  const int n0 = m + lw + j0;   // the column of lane 0
  float running = kNevsel;      // T's maximum over the earlier chunks
  for (int jc = 0, ch = 0; jc < Wl; jc += blockDim.x, ++ch) {
    const int j = jc + threadIdx.x;
    const int jg = j0 + j;
    const bool act = j < Wl;
    float x = 0.0f, g0 = 0.0f, tt = kNevsel;
    if (act) {
      const float hj = H[j], gj = G[j];
      const float hs = j + 1 < Wl ? H[j + 1] : hedge;
      const float gs = j + 1 < Wl ? G[j + 1] : gedge;
      g0 = fmaxf(hs - v, gs) - u;
      x = fmaxf(hj + score(mrow, code(b, n0 + j, lb)), g0);
      const float xp =
          j == 0 ? xin
                 : fmaxf(H[j - 1] + score(mrow, code(b, n0 + j - 1, lb)),
                         fmaxf(hj - v, gj) - u);
      tt = t_of(xp, base, jg, colb_ok, colb, vu, u);
    }
    const float incl = warp_scan_max(tt, lane);
    if (lane == 31) tot[ch & 1][warp] = incl;
    __syncthreads();
    const float wt = warp_scan_max(lane < nwarps ? tot[ch & 1][lane]
                                                 : kNevsel, lane);
    const float left = __shfl_sync(kFull, wt, warp > 0 ? warp - 1 : 0);
    const float all = __shfl_sync(kFull, wt, nwarps - 1);
    if (act) {
      const float mm = fmaxf(fmaxf(fmaxf(incl, warp > 0 ? left : kNevsel),
                                   running),
                             carry);
      const float hh = fmaxf(x, mm - (float)jg * u);
      const float h0 = valid(base, jg, lb, W) ? hh : kNegSent;
      H0[j] = h0;
      G0[j] = g0;
      if (j == 0) {
        sends[0] = h0;
        sends[1] = g0;
      }
      if (j == Wl - 1) {
        sends[2] = x;
        sends[3] = mm;
      }
    }
    running = fmaxf(running, all);
  }
}

bool bad_block(int Wl, int threads, int nalpha) {
  return Wl < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
         nalpha < 1;
}

}  // namespace

extern "C" int frontier_sweep_launch(const void* Hin, const void* Gin,
                                     void* Hout, void* Gout, const void* a,
                                     const void* b, const void* mtx,
                                     int nalpha, int la, int lb, int Wl,
                                     int lw, int W, int k, int threads,
                                     float u, float v, void* stream) {
  if (bad_block(Wl, threads, nalpha) || nalpha > kMaxAlpha || la < 0 ||
      (long long)threads * k < Wl)
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
#define K6S_CASE(KK)                                                      \
  case KK:                                                                \
    frontier_sweep_kernel<KK><<<1, threads, 0, s>>>(                      \
        (const float*)Hin, (const float*)Gin, (float*)Hout, (float*)Gout, \
        (const int*)a, (const int*)b, (const float*)mtx, nalpha, la, lb,  \
        Wl, lw, W, u, v);                                                 \
    break;
  switch (k) {
    K6S_CASE(1)
    K6S_CASE(2)
    K6S_CASE(4)
    K6S_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K6S_CASE
  return (int)cudaGetLastError();
}

extern "C" int frontier_row_launch(const void* H, const void* G, void* H0,
                                   void* G0, void* sends, const void* a,
                                   const void* b, const void* mtx,
                                   int nalpha, int m, int j0, int lb, int Wl,
                                   int lw, int W, int threads, float hedge,
                                   float gedge, float xin, float carry,
                                   float u, float v, void* stream) {
  if (bad_block(Wl, threads, nalpha) || m < 0)
    return (int)cudaErrorInvalidValue;
  frontier_row_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)G, (float*)H0, (float*)G0,
      (float*)sends, (const int*)a, (const int*)b, (const float*)mtx,
      nalpha, m, j0, lb, Wl, lw, W, hedge, gedge, xin, carry, u, v);
  return (int)cudaGetLastError();
}
