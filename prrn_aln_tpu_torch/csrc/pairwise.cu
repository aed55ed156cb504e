// Kernel K1: batched banded affine-gap (Gotoh) DP, score only.
//
// Replaces prrn_aln_tpu/ops/pallas_pairwise.py::_kernel_rows (the TPU
// row sweep launched by _launch / pallas_pairwise_scores).  Its plain
// PyTorch version is ops/pairwise.py::wavefront_scores_ref, a
// transcription of prrn_aln_tpu/ops/pairwise.py::wavefront_scores; this
// kernel runs the same recurrence with the same f32 operations in the
// same order (built with -fmad=false), so the scores are equal.
//
// What bounds it on the card: the serial anti-diagonal chain.  A pair of
// lengths La x Lb takes La + Lb - 1 dependent steps with one
// __syncthreads each, and a step touches only the ~W/2 band slots of
// its parity (W = band width + 3), a few bytes of shared memory each.
// Device-memory traffic is tiny: the two code rows and the matrix.
//
// What the design does about it: one thread block per pair, so the
// pairs of a batch run side by side on the 132 SMs and fill the card
// that one pair's chain cannot.  The band state (H, F, G) lives in
// shared memory and is updated in place: at step d only slots of
// d's parity are written and they read only their own slot and the two
// neighbours of the other parity, so no double buffer is needed.  The
// substitution score is looked up from the (dim x dim) matrix in shared
// memory by the pair's two codes; the TPU built a one-hot image of all
// scores instead, which is not needed here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr int kThreads = 256;

__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? red[lane] : kNevsel;
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void pairwise_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out,
    int Ma, int Mb, int dim, int local, int maxw) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int La = la_[p], Lb = lb_[p], LW = lw_[p], UP = up_[p];
  const float u = u_[p], v = v_[p], tgapf = tg_[p];
  const bool exg0 = exg_[4 * p + 0], exg1 = exg_[4 * p + 1];
  const bool exg2 = exg_[4 * p + 2], exg3 = exg_[4 * p + 3];
  const int32_t* a = a_batch + (size_t)p * Ma;
  const int32_t* b = b_batch + (size_t)p * Mb;
  const int W = UP - LW + 3;         // slots lw-1 .. up+1

  float* smtx = smem;
  float* hh = smtx + dim * dim;
  float* ff = hh + maxw;
  float* gg = ff + maxw;
  float* red = gg + maxw;

  for (int i = threadIdx.x; i < dim * dim; i += blockDim.x) smtx[i] = mtx[i];
  // boundary conditions (fwd2d1.cc:66-89)
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    const int r = LW - 1 + k;
    float h = 0.0f;
    if (r > 0 && !exg0) h = -(v + (float)r * u) * tgapf;
    if (r < 0 && !exg2) h = -(v - (float)r * u) * tgapf;
    if (r == LW - 1 || r == UP + 1) h = kNegSent;
    hh[k] = h;
    ff[k] = kNevsel;
    gg[k] = kNevsel;
  }
  __syncthreads();

  float maxh = kNevsel;
  const int nsteps = La + Lb - 1;
  for (int d = 0; d < nsteps; ++d) {
    for (int k = threadIdx.x; k < W; k += blockDim.x) {
      const int r = LW - 1 + k;
      if ((d - r) & 1) continue;
      const int m = (d - r) >> 1;
      const int n = d - m;
      if (m < 0 || m >= La || n < 0 || n >= Lb || r < LW || r > UP) continue;
      const float s = smtx[a[m] * dim + b[n]];
      const float h_lo = k > 0 ? hh[k - 1] : kNegSent;
      const float f_lo = k > 0 ? ff[k - 1] : kNevsel;
      const float h_hi = k < W - 1 ? hh[k + 1] : kNegSent;
      const float g_hi = k < W - 1 ? gg[k + 1] : kNevsel;
      const float f_new = fmaxf(h_lo - v, f_lo) - u;
      const float g_new = fmaxf(h_hi - v, g_hi) - u;
      float h_new = fmaxf(fmaxf(hh[k] + s, f_new), g_new);
      if (local) {
        h_new = fmaxf(h_new, 0.0f);
        maxh = fmaxf(maxh, h_new);
      }
      hh[k] = h_new;
      ff[k] = f_new;
      gg[k] = g_new;
    }
    __syncthreads();
  }

  if (local) {
    const float best = block_max(maxh, red);
    if (threadIdx.x == 0) out[p] = best;
    return;
  }
  // closed-form last row / last column maxima (pairwise.py:108-121)
  const int r_end = Lb - La;
  const float f_b = exg3 ? 0.0f : tgapf;
  const float f_a = exg1 ? 0.0f : tgapf;
  const int hi_b = min(UP + 1, Lb);
  const int lo_a = max(LW - 1, -La + 1);
  float best0 = kNevsel, best_b = kNevsel, best_a = kNevsel;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    const int r = LW - 1 + k;
    const float h = hh[k];
    if (r == r_end) best0 = fmaxf(best0, h);
    if (r > r_end && r <= hi_b)
      best_b = fmaxf(best_b, h - f_b * (v + (float)(r - r_end) * u));
    if (r < r_end && r >= lo_a)
      best_a = fmaxf(best_a, h - f_a * (v + (float)(r_end - r) * u));
  }
  float best = block_max(best0, red);
  best_b = block_max(best_b, red);
  best_a = block_max(best_a, red);
  if (f_b < 1.0f) best = fmaxf(best, best_b);
  if (f_a < 1.0f) best = fmaxf(best, best_a);
  if (threadIdx.x == 0) out[p] = best;
}

}  // namespace

extern "C" int pairwise_scores_launch(
    const void* a_batch, const void* b_batch, const void* la, const void* lb,
    const void* lw, const void* up, const void* u, const void* v,
    const void* tgapf, const void* exg, const void* mtx, void* out,
    int B, int Ma, int Mb, int dim, int local, int maxw, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)dim * dim + 3 * (size_t)maxw + 32);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairwise_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a_batch, (const int32_t*)b_batch, (const int32_t*)la,
      (const int32_t*)lb, (const int32_t*)lw, (const int32_t*)up,
      (const float*)u, (const float*)v, (const float*)tgapf,
      (const uint8_t*)exg, (const float*)mtx, (float*)out, Ma, Mb, dim,
      local, maxw);
  return (int)cudaGetLastError();
}
