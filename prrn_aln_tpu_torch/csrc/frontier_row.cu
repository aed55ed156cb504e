// Kernel K6: one row step of the band-frontier ring, on one rank's shard
// of the band.
//
// Replaces the row body of prrn_aln_tpu/ops/frontier.py::
// frontier_pairwise_score (a shard_map over a device mesh whose rows pass
// their shard-boundary lanes by ppermute).  Lane j of row m holds column
// n = m + lw + j of one pair's banded affine DP; a rank holds Wl lanes
// from j0 = rank * Wl.  The step needs three values from other ranks, so
// it is split where they arrive, into three entry points launched in
// turn by ops/frontier.py (the exchanges run on the host between them):
//
//   (a) frontier_edges: G0 = max(Hs - v, Gs) - u and X = max(H + s, G0),
//       Hs and Gs being H and G shifted one lane left with the right
//       neighbour's first lanes (hedge, gedge) at the end;
//   (b) frontier_scan: C = Xl - (v + u), Xl being X shifted one lane
//       right with the left neighbour's last lane (xin) at the front (the
//       left column's value on the lane of column 0 while that column is
//       in the band), T = C + j u and its inclusive running maximum M;
//   (c) frontier_close: M raised to the running maximum carried in from
//       the ranks to the left, E = M - j u, H0 = max(X, E), and NEG_SENT
//       off the band.
//
// Its plain PyTorch version is ops/frontier.py::frontier_row_ref, which
// follows the JAX function's f32 arithmetic as XLA compiles it on the
// CPU: X - v - u folded into X - (v + u), and the left column's
// v + (m + 1) u one fused multiply-add (__fmaf_rn here); every other
// operation is rounded on its own (built with -fmad=false).  A maximum is
// exact, so the scan's order does not matter.
//
// What bounds it on the card: not its bytes (a row moves 20 bytes a lane)
// nor its operations (about 14 a lane), but latency: three dependent
// launches a row, with the host's exchanges between them.  What the design
// does about it: H and G stay on the device from row to row, the received
// values go in as kernel arguments and the boundary lanes come back as
// single words, so a row's only traffic besides the launches is those few
// scalars.  One block a shard: the lanes go over up to 1,024 threads and
// loop past that.  The scan is a warp shuffle scan, then one over the
// warps' totals in shared memory, with the running maximum of the earlier
// chunks carried from chunk to chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void frontier_edges_kernel(const float* __restrict__ H,
                                      const float* __restrict__ G,
                                      const float* __restrict__ s,
                                      float* __restrict__ G0,
                                      float* __restrict__ X, int Wl,
                                      float hedge, float gedge, float u,
                                      float v) {
  for (int j = threadIdx.x; j < Wl; j += blockDim.x) {
    const float hs = j + 1 < Wl ? H[j + 1] : hedge;
    const float gs = j + 1 < Wl ? G[j + 1] : gedge;
    const float g0 = fmaxf(hs - v, gs) - u;
    const float d0 = H[j] + s[j];
    G0[j] = g0;
    X[j] = fmaxf(d0, g0);
  }
}

__global__ void frontier_scan_kernel(const float* __restrict__ X,
                                     float* __restrict__ M, int Wl, int m,
                                     int j0, int lw, float xin, float u,
                                     float v) {
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float mf = (float)m;
  const float vu = v + u;
  const float colb = -__fmaf_rn(mf + 1.0f, u, v);
  const bool colb_ok = m < -lw;
  float running = kNevsel;
  for (int base = 0; base < Wl; base += blockDim.x) {
    const int j = base + threadIdx.x;
    float t = kNevsel;
    if (j < Wl) {
      const int jg = j0 + j;
      float c = (j > 0 ? X[j - 1] : xin) - vu;
      const float nvec = (mf + (float)lw) + (float)jg;
      if (nvec == 0.0f && colb_ok) c = colb - vu;
      t = c + (float)jg * u;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = fmaxf(t, y);
    }
    if (lane == 31) warp_max[warp] = t;
    __syncthreads();
    if (warp == 0) {
      float w = lane < nwarps ? warp_max[lane] : kNevsel;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w = fmaxf(w, y);
      }
      if (lane < nwarps) warp_max[lane] = w;
    }
    __syncthreads();
    if (warp > 0) t = fmaxf(t, warp_max[warp - 1]);
    t = fmaxf(t, running);
    if (j < Wl) M[j] = t;
    running = fmaxf(running, warp_max[nwarps - 1]);
    __syncthreads();   // warp_max is rewritten by the next chunk
  }
}

__global__ void frontier_close_kernel(const float* __restrict__ X,
                                      const float* __restrict__ M,
                                      float* __restrict__ H0, int Wl, int m,
                                      int j0, int lw, int W, int lb,
                                      float carry, float u) {
  const float mf = (float)m;
  for (int j = threadIdx.x; j < Wl; j += blockDim.x) {
    const int jg = j0 + j;
    const float e = fmaxf(M[j], carry) - (float)jg * u;
    const float h = fmaxf(X[j], e);
    const float nvec = (mf + (float)lw) + (float)jg;
    const bool valid = nvec >= 0.0f && nvec < (float)lb && jg < W;
    H0[j] = valid ? h : kNegSent;
  }
}

bool bad_threads(int Wl, int threads) {
  return Wl < 1 || threads < 32 || threads > 1024 || threads % 32 != 0;
}

}  // namespace

extern "C" int frontier_edges_launch(const void* H, const void* G,
                                     const void* s, void* G0, void* X,
                                     int Wl, int threads, float hedge,
                                     float gedge, float u, float v,
                                     void* stream) {
  if (bad_threads(Wl, threads)) return (int)cudaErrorInvalidValue;
  frontier_edges_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)G, (const float*)s, (float*)G0,
      (float*)X, Wl, hedge, gedge, u, v);
  return (int)cudaGetLastError();
}

extern "C" int frontier_scan_launch(const void* X, void* M, int Wl,
                                    int threads, int m, int j0, int lw,
                                    float xin, float u, float v,
                                    void* stream) {
  if (bad_threads(Wl, threads)) return (int)cudaErrorInvalidValue;
  frontier_scan_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (float*)M, Wl, m, j0, lw, xin, u, v);
  return (int)cudaGetLastError();
}

extern "C" int frontier_close_launch(const void* X, const void* M, void* H0,
                                     int Wl, int threads, int m, int j0,
                                     int lw, int W, int lb, float carry,
                                     float u, void* stream) {
  if (bad_threads(Wl, threads)) return (int)cudaErrorInvalidValue;
  frontier_close_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)M, (float*)H0, Wl, m, j0, lw, W, lb,
      carry, u);
  return (int)cudaGetLastError();
}
